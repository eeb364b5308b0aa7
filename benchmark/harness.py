"""What every run shares: finding the cell's files by name, the device
check, pinned input pools, the per-layer readers, the check for JAX, and
the result line.

A cell is found from BENCHMARK.json by its workload name:
  - its configuration: `configs/<config>.json` (the `file` of its entry),
    which names its plain reference `reference/<reference>.py`;
  - its traffic: `traffic/<traffic>.json`, whose `kind` names the driver
    `drivers/<kind>.py` that runs it;
  - the limits of its correctness numbers: `limits/<workload>.json`;
  - each per-layer metric: a reader `metrics/<metric>.py` with
    `read(ctx) -> float | None`.
So a new cell, configuration or per-layer metric is new files and new
entries in BENCHMARK.json.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'glenet_tpu')
GIB = float(1 << 30)


class CellError(RuntimeError):
    """The run cannot give a result (no card, a missing file)."""


def load_json(path):
    return json.loads(Path(path).read_text())


def find_cell(root, workload):
    """The cell's files under `root` (a checkout) -> (benchmark dict, the
    workload entry, its configuration entry, configuration file, traffic,
    limits)."""
    root = Path(root)
    here = root / 'benchmark'
    bench = load_json(root / 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise CellError(f'no workload {workload!r} in BENCHMARK.json')
    cell = cells[workload]
    conf = {c['name']: c for c in bench['configs']}[cell['config']]
    config = load_json(root / conf['file'])
    traffic = load_json(here / 'traffic' / f"{cell['traffic']}.json")
    limits = load_json(here / 'limits' / f'{workload}.json')
    return bench, cell, conf, config, traffic, limits


def metrics_of(bench, cell, section):
    """The `section` ('end_to_end' or 'per_layer') metrics this cell
    reports: those listing it, and those listing no cells."""
    out = []
    for m in bench[section]:
        if cell['name'] in m.get('workloads', [cell['name']]):
            out.append(m)
    return out


def reader(name, root):
    """The per-layer reader benchmark/metrics/<name>.py under `root`."""
    path = Path(root) / 'benchmark' / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'benchmark_metric_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind):
    return importlib.import_module(f'benchmark.drivers.{kind}')


def reference(config_name):
    return importlib.import_module(f'benchmark.reference.{config_name}')


def require_cuda(chips):
    import torch
    if not torch.cuda.is_available():
        raise CellError('no CUDA device')
    if torch.cuda.device_count() < chips:
        raise CellError(f'{torch.cuda.device_count()} CUDA devices, the '
                        f'cell needs {chips}')


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device):
    if device.type == 'cuda':
        import torch
        torch.cuda.synchronize(device)


def peak_bytes(device):
    import torch
    return torch.cuda.max_memory_allocated(device) if (
        device.type == 'cuda') else 0


def reset_peak(device):
    if device.type == 'cuda':
        import torch
        torch.cuda.reset_peak_memory_stats(device)


def free_cache(device):
    import gc
    gc.collect()
    if device.type == 'cuda':
        import torch
        torch.cuda.empty_cache()


def pinned(pool, device):
    """numpy pool -> torch tensors, pinned when the device is a GPU."""
    import torch
    out = {}
    for k, v in pool.items():
        t = torch.from_numpy(v)
        out[k] = t.pin_memory() if device.type == 'cuda' else t
    return out


def to_device(pool, i, device):
    """Entry i of a pinned pool, copied as a pin_memory loader does."""
    return {k: v[i].to(device, non_blocking=True) for k, v in pool.items()}


def checks_of(numbers, limits):
    """{name: {'value', 'limit'}} of the limited numbers, and whether all
    are within their limits."""
    checks = {k: {'value': float(numbers[k]), 'limit': float(lim)}
              for k, lim in limits.items()}
    ok = all(c['value'] <= c['limit'] for c in checks.values())
    return checks, ok


def result_line(correct, attempted, failed, metrics, device, breakdown,
                checks):
    out = {'correct': bool(correct), 'attempted': int(attempted),
           'failed': int(failed), 'metrics': metrics, 'device': device}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['checks'] = checks
    return json.dumps(out)
