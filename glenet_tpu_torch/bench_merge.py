"""Times of the merge-resolve kernel at the four calls of one full-width
GLENet-VR predict, on one GPU.

    python3 -m glenet_tpu_torch.bench_merge [--out FILE.json] [--label NAME]

configs/kitti_models/GLENet_VR.yaml at full width, seeded random weights,
B = 2 synthetic KITTI-like scenes of 32768 points: one predict captures the
(ids, queries) of its four table builds.  For each call, the kernel's
device time (torch.profiler), back-to-back event time, host time per call
and cold-L2 time (utils/cuda_timing.py), torch.searchsorted's device and
event time on the same inputs (it computes `pos` only), and the bound.  The
script uses only `ops.merge_kernel.resolve_sorted_queries`, so the same file
run from two checkouts compares their kernels.  Prints the card's name and
power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from .config import cfg_from_yaml_file
from .ops import merge_kernel as mk
from .utils import cuda_timing as ct
from .utils.synthetic import scene_batches, seeded_detector

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12         # H100 SXM CUDA-core rate, no tensor cores
CALL_NAMES = ('subm L1', 'conv2_down', 'subm L2', 'conv3_down')


def capture_calls(fn):
    """Run fn(); return (copies of the (ids, queries) of each merge-resolve
    call it made, in call order, fn's result)."""
    captured = []
    real = mk.resolve_sorted_queries

    def recorder(ids, queries):
        captured.append((ids.clone(), queries.clone()))
        return real(ids, queries)

    mk.resolve_sorted_queries = recorder
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        mk.resolve_sorted_queries = real
    return captured, out


def merge_bound(ids, queries):
    """Least time for the merge-resolve function on these inputs: each input
    read once and the 4 int32 outputs written once over the memory rate,
    against ~log2(V)+3 integer compares per query over the CUDA-core rate."""
    n_q = queries.numel()
    nbytes = ids.numel() * 4 + n_q * 4 + 4 * n_q * 4
    ops = n_q * (math.ceil(math.log2(ids.shape[1] + 1)) + 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def measure_call(ids, queries):
    """Kernel and library times (ms) of one merge-resolve call."""
    def kernel():
        return mk.resolve_sorted_queries(ids, queries)

    q2 = queries.reshape(queries.shape[0], -1)

    def library():
        return torch.searchsorted(ids, q2)

    bound, by = merge_bound(ids, queries)
    return {
        'device_ms': ct.device_ms(kernel, 'merge_resolve'),
        'ms': ct.event_ms(kernel),
        'host_ms': ct.host_ms(kernel),
        'cold_ms': ct.cold_ms(kernel),
        'library_device_ms': ct.device_ms(library, 'searchsorted'),
        'library_ms': ct.event_ms(library),
        'library_host_ms': ct.host_ms(library),
        'bound_ms': bound, 'bound_by': by,
    }


def fmt(x):
    return 'not measured' if x is None else f'{x:.4f}'


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', help='write the numbers to this JSON file')
    ap.add_argument('--label', default='', help='name of this checkout')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('bench_merge: no CUDA device')
    card = ct.card_line()
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    det = seeded_detector(cfg, 'cuda', 0)
    batch = scene_batches(1)[0]
    calls = capture_calls(lambda: det.predict(batch))[0]
    rows = []
    for name, (ids, q) in zip(CALL_NAMES, calls):
        r = {'call': name, 'ids': list(ids.shape), 'queries': list(q.shape),
             **measure_call(ids, q)}
        rows.append(r)
        print(f'[{args.label}] {name}: ids {tuple(ids.shape)} queries '
              f'{tuple(q.shape)}: kernel device {fmt(r["device_ms"])} ms, '
              f'back-to-back {fmt(r["ms"])}, host {fmt(r["host_ms"])}, cold '
              f'{fmt(r["cold_ms"])}; searchsorted device '
              f'{fmt(r["library_device_ms"])}, back-to-back '
              f'{fmt(r["library_ms"])}, host {fmt(r["library_host_ms"])}; '
              f'bound {r["bound_ms"]:.4f} ({r["bound_by"]})')
    keys = [k for k in rows[0] if k.endswith('ms')]
    total = {k: (None if any(r[k] is None for r in rows)
                 else sum(r[k] for r in rows)) for k in keys}
    print(f'[{args.label}] per predict: ' + ', '.join(
        f'{k} {fmt(v)}' for k, v in total.items()) + f' (card: {card})')
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {'label': args.label, 'card': card, 'torch': torch.__version__,
             'calls': rows, 'per_predict': total}, indent=1))


if __name__ == '__main__':
    main()
