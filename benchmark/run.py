"""One run of one benchmark cell of glenet_tpu_torch on the GPU.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Builds the cell from its files (benchmark/harness.py), runs its driver
(benchmark/drivers/<kind>.py): set-up, a window of `--seconds`, then the
check of the window's outputs against the plain reference.  With
`--trace 0` it reports the cell's end-to-end metrics, with `--trace 1`
its per-layer metrics.  The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1
breakdown, and last the checks: each compared number with its limit); the
last lines of standard error list the same checks.

Exit codes: 0 a result was printed; 2 no result (no CUDA device, too few
of them, a file of the cell missing, the program absent); 3 no result
because JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()        # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / '.bench_cache'


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # caches of the program's dependencies stay inside the checkout, at
    # fixed paths; the port itself builds its kernel library into
    # glenet_tpu_torch/_build/
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ.setdefault(var, str(CACHE / sub))
    os.environ.setdefault('USE_FLAX', '0')
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    try:
        cell = harness.find_cell(ROOT, args.workload)[1]
        harness.require_cuda(cell['chips'])
        import glenet_tpu_torch  # noqa: F401  (the program under test)
    except (harness.CellError, OSError, ImportError, KeyError) as e:
        print(f'no result: {e!r}', file=sys.stderr)
        return 2
    import torch
    code, line = execute(ROOT, args, torch.device('cuda', 0))
    if line is not None:
        print(line, flush=True)
    return code


def execute(root, args, device):
    """Run the cell on `device` -> (exit code, the result line or None);
    prints the checks to standard error."""
    from benchmark import harness
    bench, cell, conf, config, traffic, limits = harness.find_cell(
        root, args.workload)
    h = types.SimpleNamespace(seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), t0=T0, config=config,
                              conf=conf, traffic=traffic, limits=limits,
                              device=device)
    out = harness.driver(traffic['kind']).run(h)
    if device.type == 'cuda':
        import torch
        name = torch.cuda.get_device_name(device)
    else:
        name = 'cpu'
    dev_info = {'platform': 'gpu' if device.type == 'cuda' else 'cpu',
                'kind': name, 'count': int(cell['chips']),
                'memory_peak_bytes': int(out['memory_peak_bytes'])}
    breakdown = None
    if args.trace:
        from benchmark.peaks import peaks_of
        ctx = out['trace']
        ctx['peaks'] = peaks_of(name)
        metrics = {}
        for m in harness.metrics_of(bench, cell, 'per_layer'):
            value = harness.reader(m['name'], root)(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
            else:       # left out of the line, which a check refuses
                print(f'missing {m["name"]}: its reader found nothing to '
                      'read', file=sys.stderr)
        prof = ctx['profile']
        dev_info.update(busy_s=prof['busy_s'], window_s=prof['window_s'])
        breakdown = {'device_ops': prof['device_ops'],
                     'idle_gaps': prof['idle_gaps']}
    else:
        metrics = {m['name']: {'value': out['e2e'][m['name']],
                               'unit': m['unit']}
                   for m in harness.metrics_of(bench, cell, 'end_to_end')}
    checks, ok = harness.checks_of(out['numbers'], limits)
    bad = harness.forbidden_modules()
    if bad:
        print(f'no result: loaded {", ".join(bad)}', file=sys.stderr)
        return 3, None
    for k, c in checks.items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    return 0, harness.result_line(ok and out['failed'] == 0,
                                  out['attempted'], out['failed'], metrics,
                                  dev_info, breakdown, checks)


if __name__ == '__main__':
    sys.exit(main())
