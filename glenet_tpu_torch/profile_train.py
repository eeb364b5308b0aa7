"""Where the time of a full-width train step goes, on one GPU.

    python3 -m glenet_tpu_torch.profile_train [--cfg_file CFG]

configs/kitti_models/GLENet_VR.yaml (or CFG: GLENet_VR_vq.yaml for the
voxel-query RoI pooling, a single-stage GLENet_S.yaml, GLENet_C.yaml,
second.yaml or second_multihead.yaml, second_iou.yaml, pv_rcnn.yaml,
PartA2.yaml, PartA2_free.yaml, pointrcnn.yaml, pointrcnn_iou.yaml,
pointpillar.yaml; or a run-time config's yaml as `python -m
glenet_tpu_torch.config NAME OUT.yaml` writes it for nuscenes_centerpoint,
lyft_second_multihead or pandaset_second) at full width, seeded random
weights,
B = BATCH_SIZE_PER_GPU (4) synthetic KITTI-like training scenes of 32768
points (PointRCNN: 16384, its sample_points) with gt boxes at their
clusters (Car; for a Car, Pedestrian and
Cyclist config objects of the three classes at KITTI's label ratios; for a
Waymo config, Waymo-like scenes of 170000 points with Vehicle boxes; for a
nuScenes, Lyft or Pandaset config their scenes, the key frame and its
sweeps, with boxes of the config's classes, lidar_scene_batches;
utils/synthetic.py), the train
voxel budget, adam_onecycle over the schedule of a full run (`total_steps`).
One warm-up step, then:
  1. per-stage wall times of 3 steps, with a device synchronise at every
     stage boundary (so the stages add up to more than an unsynchronised
     step): two-stage, forward to the dense head, train NMS, RoI sampling,
     RoI head forward, loss (anchor targets and every loss term),
     backward, optimizer (clip and adam_onecycle); single-stage, forward,
     targets + loss, backward, optimizer; for PV-RCNN the forward to the
     dense head, the keypoint stages (FPS, the set abstraction of each
     source, BEV interpolation with the fusion, PointHeadSimple) before
     the train NMS, and within the RoI head forward the RoI-grid pool
     (PV-RCNN++, pv_rcnn_plusplus*.yaml: the train NMS and the RoI
     sampling first, then the RoI masks of SPC and of the neighbour
     filters, FPS, each VectorPool source, the fusion, PointHeadSimple and
     the RoI-grid VectorPool);
     for PartA2 and PartA2-free voxelize + MeanVFE, the UNet encoder and
     decoder, the 2D backbone + dense head (PartA2 only), the part head,
     then the train NMS (PartA2-free: of the part head's boxes), RoI
     sampling and the RoI head forward with its RoI-aware pooling; for
     PointRCNN FPS (the backbone's and the RoI head's apart), each
     set-abstraction level without its FPS, the feature propagation,
     PointHeadBox, the train NMS over the point boxes, RoI sampling, RoI
     point pooling, PointRCNNHead (point_stage_times); for CaDDN
     (CaDDN.yaml, CaDDN_deeplab.yaml, camera batches) the depth network,
     the frustum volume and its sampling, Conv2DCollapse, the BEV
     backbone, the dense head, targets + loss (the depth loss with them),
     the backward and, within it, the sampling's (its f32 index_add of
     the corners' contributions), and the optimizer (camera_stage_times);
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
from .models import vector_pool
from .ops import pointnet2
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


# nuScenes' train split (700 scenes); Pandaset's: the 61 train sequences of
# pandaset_dataset.yaml, 80 frames each; Lyft's: assumed
TRAIN_FRAMES = {'WaymoDataset': WAYMO_TRAIN_FRAMES,
                'NuScenesDataset': 28130, 'LyftDataset': 18900,
                'PandasetDataset': 61 * 80}


def train_frames(cfg):
    """Frames of a full run's train split for the config's dataset."""
    return TRAIN_FRAMES.get(cfg.DATA_CONFIG.get('DATASET'),
                            KITTI_TRAIN_FRAMES)


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
    pv = det.net.pfe is not None
    undo = [_wrap(marks, det, 'compute_loss', 'loss>', 'loss<'),
            _wrap(marks, tx, 'update', 'backward<', 'update<')]
    sa_names, hooks = [], []
    pvpp = pv and det.net.pvpp
    masks = []
    if pv:
        sa_names = [name for name, _ in det.net.pfe.aggregators.values()]
        head = det.net.roi_head
        mods = dict(pfe=det.net.pfe,
                    point_head_simple=det.net.point_head_simple,
                    roi_grid_pool=(head.roi_grid_vpool if head.vector_pool
                                   else head.roi_grid_pool),
                    **{n: getattr(det.net.pfe, n) for n in sa_names})
        for name, mod in mods.items():
            hooks.append(mod.register_forward_pre_hook(
                lambda *_, name=name: _mark(marks, f'{name}>')))
            hooks.append(mod.register_forward_hook(
                lambda *_, name=name: _mark(marks, f'{name}<')))
        real_fps = pointnet2.farthest_point_sample

        def fps(*args, **kwargs):
            _mark(marks, 'fps>')
            out = real_fps(*args, **kwargs)
            _mark(marks, 'fps<')
            return out

        pointnet2.farthest_point_sample = fps
        real_masks = vector_pool.sample_points_with_roi_mask

        def roi_masks(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = real_masks(*args, **kwargs)
            torch.cuda.synchronize()
            masks.append(time.perf_counter() - start)
            return out

        vector_pool.sample_points_with_roi_mask = roi_masks
        undo += [lambda: setattr(pointnet2, 'farthest_point_sample',
                                 real_fps),
                 lambda: setattr(vector_pool, 'sample_points_with_roi_mask',
                                 real_masks)] + [h.remove for h in hooks]
    part = det.net.part_head is not None
    if part:
        undo += [_wrap(marks, det.net.backbone_3d, 'encode', 'enc>', 'enc<'),
                 _wrap(marks, det.net.backbone_3d, 'decode', 'dec>', 'dec<'),
                 _wrap(marks, det.net, '_part_head', 'part>', 'part<'),
                 _wrap(marks, det.net.roi_head, 'pool', 'pool>', 'pool<')]
    if two_stage:
        proposals = ('_point_proposals' if det.net.part_free
                     else '_proposals')
        undo += [_wrap(marks, det.net, proposals, 'nms>', 'nms<'),
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
    if part:
        spans = {'voxelize + MeanVFE': t['enc>'] - t0,
                 'UNet encoder': t['enc<'] - t['enc>'],
                 'UNet decoder': t['dec<'] - t['dec>']}
        if not det.net.part_free:
            spans['2D backbone + dense head'] = t['part>'] - t['dec<']
        spans['part head'] = t['part<'] - t['part>']
    elif two_stage:
        spans = {'forward to the dense head':
                 t['pfe>' if pv and not pvpp else 'nms>'] - t0}
    if two_stage:
        if pvpp:
            # PV-RCNN++ samples its RoIs before the keypoints
            spans.update({'train NMS': t['nms<'] - t['nms>'],
                          'RoI sampling': t['sample<'] - t['nms<']})
            spans['PFE: RoI masks (SPC, neighbour filters)'] = sum(masks)
        if pv:
            sa = {n: t[f'{n}<'] - t[f'{n}>'] for n in sa_names}
            fps = t['fps<'] - t['fps>']
            spans['PFE: FPS'] = fps
            spans.update({f'PFE: {n}': v for n, v in sa.items()})
            spans['PFE: BEV interpolation + fusion'] = (
                t['pfe<'] - t['pfe>'] - fps - sum(masks) - sum(sa.values()))
            spans['PointHeadSimple'] = (t['point_head_simple<']
                                        - t['point_head_simple>'])
        if not pvpp:
            spans.update({'train NMS': t['nms<'] - t['nms>'],
                          'RoI sampling': t['sample<'] - t['nms<']})
        spans['RoI head forward'] = t['head<'] - t[
            'head>' if pvpp else 'sample<']
        if pv:
            spans['  of it RoI-grid pool'] = (t['roi_grid_pool<']
                                              - t['roi_grid_pool>'])
        if part:
            spans['  of it RoI-aware pooling'] = t['pool<'] - t['pool>']
        spans['loss'] = t['loss<'] - t['head<']
    else:
        spans = {'forward': t['loss>'] - t0,
                 'targets + loss': t['loss<'] - t['loss>']}
    spans.update({'backward': t['backward<'] - t['loss<'],
                  'optimizer': t['update<'] - t['backward<']})
    return state, {k: 1e3 * v for k, v in spans.items()}, 1e3 * (t_end - t0)


def point_stage_times(det, tx, state, train_step, batch):
    """PointRCNN: one train step with a synchronise at every stage
    boundary -> (state, {stage: ms}, step ms)."""
    net = det.net
    bb = net.backbone_3d
    marks, fps = [], []
    undo = [_wrap(marks, det, 'compute_loss', 'loss>', 'loss<'),
            _wrap(marks, tx, 'update', 'backward<', 'update<')]
    mods = {f'sa_{i}': getattr(bb, f'sa_{i}') for i in range(bb.n_sa)}
    mods.update({f'fp_{i}': getattr(bb, f'fp_{i}') for i in range(bb.n_fp)})
    mods['point_head'] = net.point_head
    two_stage = net.roi_head is not None
    if two_stage:
        mods['roi_head'] = net.roi_head
        undo += [_wrap(marks, net, '_nms_proposals', 'nms>', 'nms<'),
                 _wrap(marks, net, '_sample_roi_targets', 'sample>',
                       'sample<'),
                 _wrap(marks, net, '_pool_roi_points', 'pool>', 'pool<')]
    for name, mod in mods.items():
        undo += [mod.register_forward_pre_hook(
            lambda *_, name=name: _mark(marks, f'{name}>')).remove,
                 mod.register_forward_hook(
            lambda *_, name=name: _mark(marks, f'{name}<')).remove]
    real_fps = pointnet2.farthest_point_sample

    def timed_fps(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real_fps(*args, **kwargs)
        torch.cuda.synchronize()
        fps.append((start, time.perf_counter()))
        return out

    pointnet2.farthest_point_sample = timed_fps
    undo.append(lambda: setattr(pointnet2, 'farthest_point_sample',
                                real_fps))
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

    def span(name):
        return t[f'{name}<'] - t[f'{name}>']

    def fps_in(name):
        return sum(e - s for s, e in fps
                   if t[f'{name}>'] <= s and e <= t[f'{name}<'])

    spans = {'FPS (backbone)': sum(fps_in(f'sa_{i}')
                                   for i in range(bb.n_sa))}
    for i in range(bb.n_sa):
        spans[f'SA level {i} without FPS'] = span(f'sa_{i}') - fps_in(
            f'sa_{i}')
    spans['feature propagation'] = sum(span(f'fp_{i}')
                                       for i in range(bb.n_fp))
    spans['PointHeadBox'] = span('point_head')
    if two_stage:
        spans.update({'train NMS': span('nms'), 'RoI sampling': span('sample'),
                      'RoI point pooling': span('pool'),
                      'FPS (RoI head)': fps_in('roi_head')})
        spans['PointRCNNHead without FPS'] = (span('roi_head')
                                              - spans['FPS (RoI head)'])
    spans.update({'loss': span('loss'),
                  'backward': t['backward<'] - t['loss<'],
                  'optimizer': t['update<'] - t['backward<']})
    return state, {k: 1e3 * v for k, v in spans.items()}, 1e3 * (t_end - t0)


def camera_stage_times(det, tx, state, train_step, batch):
    """CaDDN: one train step with a synchronise at every stage boundary
    -> (state, {stage: ms}, step ms)."""
    from .models import image_vfe
    from .profile_predict import camera_hooks, camera_spans
    marks, dict_marks, sampler = [], {}, []
    undo = [_wrap(marks, det, 'compute_loss', 'loss>', 'loss<'),
            _wrap(marks, tx, 'update', 'backward<', 'update<')]
    hooks = camera_hooks(det.net, dict_marks)
    real = image_vfe.accumulate_volume_grad

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        sampler.append(time.perf_counter() - start)
        return out

    image_vfe.accumulate_volume_grad = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        image_vfe.accumulate_volume_grad = real
        for h in hooks:
            h.remove()
        for u in undo:
            u()
    t = dict(marks)
    spans = camera_spans(dict_marks)
    spans.update({'targets + loss': t['loss<'] - t['loss>'],
                  'backward': t['backward<'] - t['loss<'],
                  '  of it the sampling\'s': sum(sampler),
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
    print(f'{cfg.TAG} train step, B={batch_size}' + (
          '' if det.net.camera else
          f', train voxel budget {det.max_voxels_train}') + ', total_steps '
          f'{total_steps(cfg.OPTIMIZATION, train_frames(cfg))}')
    state, _ = train_step(state, batches[0])
    torch.cuda.synchronize()

    totals = {}
    torch.cuda.reset_peak_memory_stats()
    timed_step = (point_stage_times if det.point_based
                  else camera_stage_times if det.net.camera else stage_times)
    for batch in batches[1:1 + STEPS]:
        state, spans, total = timed_step(det, tx, state, train_step, batch)
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
