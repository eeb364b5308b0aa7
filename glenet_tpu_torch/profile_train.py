"""Where the time of a full-width train step goes, on one GPU.

    python3 -m glenet_tpu_torch.profile_train [--cfg_file CFG]

configs/kitti_models/GLENet_VR.yaml (or CFG: GLENet_VR_vq.yaml for the
voxel-query RoI pooling, or a single-stage GLENet_S.yaml, GLENet_C.yaml,
second.yaml) at full width, seeded random weights,
B = BATCH_SIZE_PER_GPU (4) synthetic KITTI-like training scenes of 32768
points with Car gt boxes at their clusters (for a Waymo config, Waymo-like
scenes of 170000 points with Vehicle boxes; utils/synthetic.py), the train
voxel budget, adam_onecycle over the schedule of a full run (`total_steps`).
One warm-up step, then:
  1. per-stage wall times of 3 steps, with a device synchronise at every
     stage boundary (so the stages add up to more than an unsynchronised
     step): two-stage, forward to the dense head, train NMS, RoI sampling,
     RoI head forward, loss (anchor targets and every loss term),
     backward, optimizer (clip and adam_onecycle); single-stage, forward,
     targets + loss, backward, optimizer;
  2. a torch.profiler window over 3 steps without those synchronises: the
     device busy share (summed device time of the kernels over the window's
     wall time) and the top 30 device operators;
  3. peak device memory of a step.
Prints the card's name and power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import torch

from .config import cfg_from_yaml_file
from .train import optim
from .train import state as train_state
from .utils.cuda_timing import card_line, profile_window
from .utils.synthetic import batches_for, seeded_detector

ROOT = Path(__file__).resolve().parent.parent
KITTI_TRAIN_FRAMES = 3712       # KITTI's train split (ImageSets/train.txt)
# Waymo's train split (v1.2: 798 sequences, 158081 frames) at
# waymo_dataset.yaml's SAMPLED_INTERVAL of 5
WAYMO_TRAIN_FRAMES = 31617
STEPS, TOP = 3, 30


def train_frames(cfg):
    """Frames of a full run's train split for the config's dataset."""
    return (WAYMO_TRAIN_FRAMES
            if cfg.DATA_CONFIG.get('DATASET') == 'WaymoDataset'
            else KITTI_TRAIN_FRAMES)


def total_steps(opt_cfg, frames=KITTI_TRAIN_FRAMES):
    """Optimizer steps of a full run: NUM_EPOCHS x iterations per epoch
    (80 x 928 for GLENet_VR.yaml on KITTI, 30 x 7905 for Waymo's
    GLENet_S.yaml)."""
    return int(opt_cfg.NUM_EPOCHS) * math.ceil(
        frames / int(opt_cfg.BATCH_SIZE_PER_GPU))


def build_training(cfg, det):
    """adam_onecycle over a full run's schedule for `det`: returns (tx,
    state, train_step)."""
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION,
                                  total_steps(cfg.OPTIMIZATION,
                                              train_frames(cfg)))
    state = train_state.create_train_state(det, tx)
    return tx, state, train_state.make_train_step(det, tx)


def _mark(marks, name):
    torch.cuda.synchronize()
    marks.append((name, time.perf_counter()))


def _wrap(marks, obj, attr, before=None, after=None):
    """Shadow obj.attr with a version that synchronises and records a mark
    before and / or after each call; returns an undo function."""
    real = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        if before:
            _mark(marks, before)
        out = real(*args, **kwargs)
        if after:
            _mark(marks, after)
        return out

    setattr(obj, attr, wrapped)
    return lambda: delattr(obj, attr)


def stage_times(det, tx, state, train_step, batch):
    """One train step with a synchronise at every stage boundary -> (state,
    {stage: ms}, step ms)."""
    marks = []
    two_stage = det.net.roi_head is not None
    undo = [_wrap(marks, det, 'compute_loss', 'loss>', 'loss<'),
            _wrap(marks, tx, 'update', 'backward<', 'update<')]
    if two_stage:
        undo += [_wrap(marks, det.net, '_proposals', 'nms>', 'nms<'),
                 _wrap(marks, det.net, '_sample_roi_targets', None,
                       'sample<'),
                 _wrap(marks, det.net.roi_head, 'forward', 'head>', 'head<')]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        for u in undo:
            u()
    t = dict(marks)
    if two_stage:
        spans = {'forward to the dense head': t['nms>'] - t0,
                 'train NMS': t['nms<'] - t['nms>'],
                 'RoI sampling': t['sample<'] - t['nms<'],
                 'RoI head forward': t['head<'] - t['sample<'],
                 'loss': t['loss<'] - t['head<']}
    else:
        spans = {'forward': t['loss>'] - t0,
                 'targets + loss': t['loss<'] - t['loss>']}
    spans.update({'backward': t['backward<'] - t['loss<'],
                  'optimizer': t['update<'] - t['backward<']})
    return state, {k: 1e3 * v for k, v in spans.items()}, 1e3 * (t_end - t0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg_file', type=str, default=str(
        ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_train: no CUDA device')
    card = card_line()
    print(f'card: {card}')
    cfg = cfg_from_yaml_file(args.cfg_file)
    det = seeded_detector(cfg, 'cuda', 0)
    tx, state, train_step = build_training(cfg, det)
    batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    batches = batches_for(cfg, 1 + 2 * STEPS, seed=0, batch=batch_size,
                          train=True)
    print(f'{cfg.TAG} train step, B={batch_size}, train voxel budget '
          f'{det.max_voxels_train}, total_steps '
          f'{total_steps(cfg.OPTIMIZATION, train_frames(cfg))}')
    state, _ = train_step(state, batches[0])
    torch.cuda.synchronize()

    totals = {}
    torch.cuda.reset_peak_memory_stats()
    for batch in batches[1:1 + STEPS]:
        state, spans, total = stage_times(det, tx, state, train_step, batch)
        spans['step (synchronised stages)'] = total
        for k, v in spans.items():
            totals[k] = totals.get(k, 0.0) + v / STEPS
    peak = torch.cuda.max_memory_allocated()
    print(f'stage wall times, mean of {STEPS} steps (ms):')
    for k, v in totals.items():
        print(f'  {k:32s} {v:9.2f}')
    print(f'peak device memory {peak / 2**30:.2f} GiB '
          f'(max_memory_allocated)')

    feed = iter(batches[1 + STEPS:])

    def step():
        nonlocal state
        state, _ = train_step(state, next(feed))

    wall, dev_total, events = profile_window(step, STEPS)
    print(f'profiled window: {STEPS} steps, wall {wall:.1f} ms, device '
          f'kernel time {dev_total:.1f} ms, busy share '
          f'{dev_total / wall:.3f} (card: {card})')
    print(events.table(sort_by='self_device_time_total', row_limit=TOP,
                       max_name_column_width=60))


if __name__ == '__main__':
    main()
