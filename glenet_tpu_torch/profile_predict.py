"""Where the time of a full-width GLENet-VR predict goes, on one GPU.

    python3 -m glenet_tpu_torch.profile_predict

configs/kitti_models/GLENet_VR.yaml at full width, seeded random weights,
B = 2 synthetic KITTI-like scenes of 32768 points (utils/synthetic.py), one
warm-up predict, then:
  1. the wall time of 3 requests as a caller sees it (a device synchronise
     after each request only);
  2. per-stage wall times of the same 3 requests, with a device synchronise
     at every stage boundary (so the stages add up to more than 1.);
  3. a torch.profiler window over 3 requests without those synchronises:
     the device busy share (summed device time of the kernels over the
     window's wall time) and the top 30 device operators.
Prints the card's name and power limit beside the numbers.
"""
from __future__ import annotations

import time
from pathlib import Path

import torch

from .config import cfg_from_yaml_file
from .utils.cuda_timing import card_line, profile_window
from .utils.synthetic import scene_batches, seeded_detector

ROOT = Path(__file__).resolve().parent.parent
STAGES = ('backbone_3d', 'backbone_2d', 'dense_head', 'roi_head')
REQUESTS, TOP = 3, 30


def _stage_times(det, batch):
    """Synchronised wall time of each predict stage (ms)."""
    marks = []

    def mark(name):
        def hook(*_):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))
        return hook

    hooks = []
    for name in STAGES:
        mod = getattr(det.net, name)
        hooks.append(mod.register_forward_pre_hook(mark(f'{name}>')))
        hooks.append(mod.register_forward_hook(mark(f'{name}<')))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.predict(batch)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    for h in hooks:
        h.remove()
    t = dict(marks)
    spans = {
        'voxelize + MeanVFE': t['backbone_3d>'] - t0,
        'VoxelBackBone8x': t['backbone_3d<'] - t['backbone_3d>'],
        'BaseBEVBackbone': t['backbone_2d<'] - t['backbone_2d>'],
        'AnchorHeadSingle': t['dense_head<'] - t['dense_head>'],
        'decode + proposal NMS': t['roi_head>'] - t['dense_head<'],
        'VoxelRCNNHead': t['roi_head<'] - t['roi_head>'],
        'decode + variance-voting NMS': t_end - t['roi_head<'],
    }
    return {k: 1e3 * v for k, v in spans.items()}, 1e3 * (t_end - t0)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('profile_predict: no CUDA device')
    card = card_line()
    print(f'card: {card}')
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    det = seeded_detector(cfg, 'cuda', 0)
    batches = scene_batches(REQUESTS + 1)
    det.predict(batches[0])
    torch.cuda.synchronize()

    times = []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        det.predict(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print('predict wall times (ms): ' + ' / '.join(f'{t:.2f}' for t in times)
          + f', mean {sum(times) / len(times):.2f}')

    totals = {}
    for batch in batches[1:]:
        spans, total = _stage_times(det, batch)
        for k, v in spans.items():
            totals[k] = totals.get(k, 0.0) + v / REQUESTS
        totals['predict (synchronised stages)'] = (
            totals.get('predict (synchronised stages)', 0.0)
            + total / REQUESTS)
    print(f'stage wall times, mean of {REQUESTS} requests (ms):')
    for k, v in totals.items():
        print(f'  {k:32s} {v:9.2f}')

    feed = iter(batches[1:])
    wall, dev_total, events = profile_window(
        lambda: det.predict(next(feed)), REQUESTS)
    print(f'profiled window: {REQUESTS} requests, wall {wall:.1f} ms, '
          f'device kernel time {dev_total:.1f} ms, busy share '
          f'{dev_total / wall:.3f} (card: {card})')
    print(events.table(sort_by='self_device_time_total', row_limit=TOP,
                       max_name_column_width=60))


if __name__ == '__main__':
    main()
