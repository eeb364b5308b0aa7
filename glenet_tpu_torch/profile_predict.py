"""Where the time of a full-width predict goes, on one GPU.

    python3 -m glenet_tpu_torch.profile_predict [--cfg_file CFG]

configs/kitti_models/GLENet_VR.yaml (or CFG, e.g. a single-stage
GLENet_S.yaml, GLENet_C.yaml or second.yaml) at full width, seeded random
weights,
B = 2 synthetic KITTI-like scenes of 32768 points (for a Waymo config,
configs/waymo_models/*.yaml, Waymo-like scenes of 170000 points with 5
features; utils/synthetic.py), one warm-up predict, then:
  1. the wall time of 3 requests as a caller sees it (a device synchronise
     after each request only);
  2. per-stage wall times of the same 3 requests, with a device synchronise
     at every stage boundary (so the stages add up to more than 1.):
     voxelize + MeanVFE, the 3D backbone, the 2D backbone, the dense head,
     then two-stage decode + proposal NMS, the RoI head and decode +
     final NMS, or single-stage decode + final NMS; within the final
     NMS, the time of its rotated-IoU matrix (`boxes_iou_bev_blocked`)
     and of its greedy keep rounds (`greedy_keep`);
  3. a torch.profiler window over 3 requests without those synchronises:
     the device busy share (summed device time of the kernels over the
     window's wall time) and the top 30 device operators.
Prints the card's name and power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from .config import cfg_from_yaml_file
from .ops import iou3d
from .ops import nms as nms_ops
from .utils.cuda_timing import card_line, profile_window
from .utils.synthetic import batches_for, seeded_detector

ROOT = Path(__file__).resolve().parent.parent
REQUESTS, TOP = 3, 30


def _stage_times(det, batch):
    """Synchronised wall time of each predict stage (ms)."""
    marks = []

    def mark(name):
        def hook(*_):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))
        return hook

    two_stage = det.net.roi_head is not None
    names = ('backbone_3d', 'backbone_2d', 'dense_head') + (
        ('roi_head',) if two_stage else ())
    hooks = []
    for name in names:
        mod = getattr(det.net, name)
        hooks.append(mod.register_forward_pre_hook(mark(f'{name}>')))
        hooks.append(mod.register_forward_hook(mark(f'{name}<')))
    calls = []
    undo = [_timed(iou3d, 'boxes_iou_bev_blocked', 'rotated-IoU matrix',
                   calls),
            _timed(nms_ops, 'greedy_keep', 'greedy keep rounds', calls)]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.predict(batch)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        for h in hooks:
            h.remove()
        for u in undo:
            u()
    t = dict(marks)
    mcfg = det.model_cfg
    spans = {
        'voxelize + MeanVFE': t['backbone_3d>'] - t0,
        mcfg.BACKBONE_3D.NAME: t['backbone_3d<'] - t['backbone_3d>'],
        mcfg.BACKBONE_2D.NAME: t['backbone_2d<'] - t['backbone_2d>'],
        mcfg.DENSE_HEAD.NAME: t['dense_head<'] - t['dense_head>']}
    nms = ('variance-voting' if mcfg.POST_PROCESSING.NMS_CONFIG.NMS_TYPE
           != 'nms_gpu' else 'greedy')
    if two_stage:
        spans.update({
            'decode + proposal NMS': t['roi_head>'] - t['dense_head<'],
            mcfg.ROI_HEAD.NAME: t['roi_head<'] - t['roi_head>'],
            f'decode + {nms} NMS': t_end - t['roi_head<']})
    else:
        spans[f'decode + {nms} NMS'] = t_end - t['dense_head<']
    final = t['roi_head<' if two_stage else 'dense_head<']
    for label in ('rotated-IoU matrix', 'greedy keep rounds'):
        spans[f'  of it {label}'] = sum(
            end - start for lab, start, end in calls
            if lab == label and start >= final)
    return {k: 1e3 * v for k, v in spans.items()}, 1e3 * (t_end - t0)


def _timed(module, attr, label, calls):
    """Shadow module.attr so that each call appends (label, start, end),
    synchronised; returns an undo function."""
    real = getattr(module, attr)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((label, start, time.perf_counter()))
        return out

    setattr(module, attr, wrapped)
    return lambda: setattr(module, attr, real)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg_file', type=str, default=str(
        ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_predict: no CUDA device')
    card = card_line()
    print(f'card: {card}')
    cfg = cfg_from_yaml_file(args.cfg_file)
    det = seeded_detector(cfg, 'cuda', 0)
    print(f'{cfg.TAG} predict, B=2, test voxel budget {det.max_voxels_test}')
    batches = batches_for(cfg, REQUESTS + 1)
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
