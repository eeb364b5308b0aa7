"""Where the time of a full-width predict goes, on one GPU.

    python3 -m glenet_tpu_torch.profile_predict [--cfg_file CFG]

configs/kitti_models/GLENet_VR.yaml (or CFG, e.g. a single-stage
GLENet_S.yaml, GLENet_C.yaml, second.yaml or second_multihead.yaml, the
two-stage second_iou.yaml, pv_rcnn.yaml, PartA2.yaml, PartA2_free.yaml or
pointrcnn.yaml, or pointpillar.yaml, or configs/waymo_models/
centerpoint*.yaml and the CenterHead-RPN configs, or a run-time config's
yaml as `python -m glenet_tpu_torch.config NAME OUT.yaml` writes it for
nuscenes_centerpoint, lyft_second_multihead or pandaset_second) at full
width, seeded random weights,
B = 2 synthetic KITTI-like scenes of 32768 points (PointRCNN: 16384, its
sample_points; for a Waymo config,
configs/waymo_models/*.yaml, Waymo-like scenes of 170000 points with 5
features; for a nuScenes, Lyft or Pandaset config their scenes of
lidar_scene_batches, the key frame and its sweeps up to
MAX_POINTS_PER_SCENE; utils/synthetic.py), one warm-up predict, then:
  1. the wall time of 3 requests as a caller sees it (a device synchronise
     after each request only);
  2. per-stage wall times of the same 3 requests, with a device synchronise
     at every stage boundary (so the stages add up to more than 1.):
     voxelize + the VFE and the 3D backbone (pillars: voxelize, the
     pillar VFE, PointPillarScatter), the 2D backbone, the dense head,
     then two-stage decode + proposal NMS, the RoI head and decode +
     final NMS, or single-stage decode + final NMS; for PV-RCNN also the
     keypoint stages (FPS, the set abstraction of each source, BEV
     interpolation with the fusion, PointHeadSimple) and, within
     PVRCNNHead, the RoI-grid pool and the FCs (PV-RCNN++,
     pv_rcnn_plusplus*.yaml: the proposal NMS before the keypoints, the
     RoI masks of SPC and of the neighbour filters, each VectorPool source
     and the RoI-grid VectorPool); for PartA2 and
     PartA2-free the UNet encoder and decoder within UNetV2, the part head
     (PointIntraPartOffsetHead) and, within PartA2FCHead, the RoI-aware
     pooling and the convs + FCs (PartA2-free has no 2D backbone or dense
     head: its proposals are the part head's boxes); within the final
     NMS, the time of its rotated-IoU matrix (`boxes_iou_bev_blocked`)
     and of its greedy keep rounds (`greedy_keep`), and CenterPoint's
     top-k decode (`decode_center_boxes`); PointRCNN's stages are
     FPS (the backbone's and the RoI head's apart), each set-abstraction
     level without its FPS, the feature propagation, PointHeadBox, the
     proposal NMS, the RoI point pooling, PointRCNNHead and the final
     NMS (point_stage_times); CaDDN's (CaDDN.yaml, CaDDN_deeplab.yaml:
     camera batches, utils/synthetic.camera_batches) are the depth
     network (with DeepLabV3 its channel_reduce block), the frustum
     volume and its sampling, Conv2DCollapse, the BEV backbone, the dense
     head and decode + final NMS (camera_stage_times);
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
from .models import center_head, vector_pool
from .ops import iou3d
from .ops import nms as nms_ops
from .ops import pointnet2
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
    pillars = det.net.backbone_3d is None
    pv = det.net.pfe is not None
    part = det.net.part_head is not None
    bev = not det.net.part_free
    names = (('vfe', 'map_to_bev') if pillars else ('backbone_3d',)) + (
        ('backbone_2d', 'dense_head') if bev else ()) + (
        ('part_head',) if part else ()) + (('roi_head',) if two_stage else ())
    mods = {n: getattr(det.net, n) for n in names}
    sa_names = []
    pvpp = pv and det.net.pvpp
    if pv:
        sa_names = [name for name, _ in det.net.pfe.aggregators.values()]
        head = det.net.roi_head
        mods.update(pfe=det.net.pfe,
                    point_head_simple=det.net.point_head_simple,
                    roi_grid_pool=(head.roi_grid_vpool if head.vector_pool
                                   else head.roi_grid_pool),
                    **{n: getattr(det.net.pfe, n) for n in sa_names})
    hooks = []
    for name, mod in mods.items():
        hooks.append(mod.register_forward_pre_hook(mark(f'{name}>')))
        hooks.append(mod.register_forward_hook(mark(f'{name}<')))
    calls = []
    undo = [_timed(iou3d, 'boxes_iou_bev_blocked', 'rotated-IoU matrix',
                   calls),
            _timed(center_head, 'decode_center_boxes', 'top-k decode',
                   calls),
            _timed(nms_ops, 'greedy_keep', 'greedy keep rounds', calls),
            _timed(pointnet2, 'farthest_point_sample', 'FPS', calls),
            _timed(vector_pool, 'sample_points_with_roi_mask', 'RoI masks',
                   calls)]
    if part:
        unet, head = det.net.backbone_3d, det.net.roi_head
        undo += [_timed(unet, 'encode', 'UNet encoder', calls),
                 _timed(unet, 'decode', 'UNet decoder', calls),
                 _timed(head, 'pool', 'RoI-aware pooling', calls)]
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

    def called(label):
        return sum(end - start for lab, start, end in calls if lab == label)

    if pillars:
        spans = {'voxelize': t['vfe>'] - t0,
                 mcfg.VFE.NAME: t['vfe<'] - t['vfe>'],
                 mcfg.MAP_TO_BEV.NAME: t['map_to_bev<'] - t['map_to_bev>']}
    else:
        spans = {f'voxelize + {mcfg.VFE.NAME}': t['backbone_3d>'] - t0,
                 mcfg.BACKBONE_3D.NAME: t['backbone_3d<']
                 - t['backbone_3d>']}
    if part:
        spans.update({f'  of it {k}': called(k)
                      for k in ('UNet encoder', 'UNet decoder')})
    if bev:
        spans.update({
            mcfg.BACKBONE_2D.NAME: t['backbone_2d<'] - t['backbone_2d>'],
            mcfg.DENSE_HEAD.NAME: t['dense_head<'] - t['dense_head>']})
    if part:
        spans[mcfg.POINT_HEAD.NAME] = t['part_head<'] - t['part_head>']
    nms = ('variance-voting' if mcfg.POST_PROCESSING.NMS_CONFIG.NMS_TYPE
           != 'nms_gpu' else 'greedy')
    if pvpp:
        # PV-RCNN++ takes its proposals before the keypoints
        spans['decode + proposal NMS'] = t['pfe>'] - t['dense_head<']
    if pv:
        fps, masks = called('FPS'), called('RoI masks')
        sa = {n: t[f'{n}<'] - t[f'{n}>'] for n in sa_names}
        if pvpp:
            spans['PFE: RoI masks (SPC, neighbour filters)'] = masks
        spans['PFE: FPS'] = fps
        spans.update({f'PFE: {n}': v for n, v in sa.items()})
        spans['PFE: BEV interpolation + fusion'] = (
            t['pfe<'] - t['pfe>'] - fps - masks - sum(sa.values()))
        spans['PointHeadSimple'] = (t['point_head_simple<']
                                    - t['point_head_simple>'])
    if two_stage and not pvpp:
        spans['decode + proposal NMS'] = t['roi_head>'] - t[
            'point_head_simple<' if pv else 'part_head<' if part
            else 'dense_head<']
    if two_stage:
        spans[mcfg.ROI_HEAD.NAME] = t['roi_head<'] - t['roi_head>']
        if pv or part:
            pool = (t['roi_grid_pool<'] - t['roi_grid_pool>'] if pv
                    else called('RoI-aware pooling'))
            spans['  of it RoI-grid pool' if pv
                  else '  of it RoI-aware pooling'] = pool
            spans['  of it the FCs' if pv else '  of it the convs + FCs'] = (
                spans[mcfg.ROI_HEAD.NAME] - pool)
        spans[f'decode + {nms} NMS'] = t_end - t['roi_head<']
    else:
        spans[f'decode + {nms} NMS'] = t_end - t['dense_head<']
    final = t['roi_head<' if two_stage else 'dense_head<']
    labels = ('rotated-IoU matrix', 'greedy keep rounds')
    if det.is_center_head and not two_stage:
        labels = ('top-k decode',) + labels
    for label in labels:
        spans[f'  of it {label}'] = sum(
            end - start for lab, start, end in calls
            if lab == label and start >= final)
    return {k: 1e3 * v for k, v in spans.items()}, 1e3 * (t_end - t0)


def point_stage_times(det, batch):
    """PointRCNN's synchronised stage wall times (ms) of one predict, and
    the predict's: FPS within the backbone and within the RoI head, each
    SA level without its FPS, FP, PointHeadBox, proposal NMS, RoI point
    pooling, PointRCNNHead (without its FPS) and the final NMS."""
    from .ops import roipoint_pool
    net = det.net
    bb = net.backbone_3d
    marks, calls, hooks = {}, [], []

    def mark(name):
        def hook(*_):
            torch.cuda.synchronize()
            marks.setdefault(name, []).append(time.perf_counter())
        return hook

    mods = {f'sa_{i}': getattr(bb, f'sa_{i}') for i in range(bb.n_sa)}
    mods.update({f'fp_{i}': getattr(bb, f'fp_{i}') for i in range(bb.n_fp)})
    mods['point_head'] = net.point_head
    if net.roi_head is not None:
        mods['roi_head'] = net.roi_head
    for name, mod in mods.items():
        hooks += [mod.register_forward_pre_hook(mark(f'{name}>')),
                  mod.register_forward_hook(mark(f'{name}<'))]
    undo = [_timed(pointnet2, 'farthest_point_sample', 'FPS', calls),
            _timed(roipoint_pool, 'roipoint_pool3d', 'pool', calls),
            _timed(net, '_nms_proposals', 'proposal NMS', calls)]
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

    def span(name):
        return marks[f'{name}<'][0] - marks[f'{name}>'][0]

    def fps_in(name):
        lo, hi = marks[f'{name}>'][0], marks[f'{name}<'][0]
        return sum(e - s for lab, s, e in calls
                   if lab == 'FPS' and lo <= s and e <= hi)

    spans = {'FPS (backbone)': sum(fps_in(f'sa_{i}')
                                   for i in range(bb.n_sa))}
    for i in range(bb.n_sa):
        spans[f'SA level {i} without FPS'] = span(f'sa_{i}') - fps_in(
            f'sa_{i}')
    spans['feature propagation'] = sum(span(f'fp_{i}')
                                       for i in range(bb.n_fp))
    spans['PointHeadBox'] = span('point_head')
    last = marks['point_head<'][0]
    if net.roi_head is not None:
        spans['proposal NMS'] = sum(e - s for lab, s, e in calls
                                    if lab == 'proposal NMS')
        spans['RoI point pooling'] = sum(e - s for lab, s, e in calls
                                         if lab == 'pool')
        spans['FPS (RoI head)'] = fps_in('roi_head')
        spans['PointRCNNHead without FPS'] = (span('roi_head')
                                              - spans['FPS (RoI head)'])
        last = marks['roi_head<'][0]
    spans['decode + final NMS'] = t_end - last
    return {k: 1e3 * v for k, v in spans.items()}, 1e3 * (t_end - t0)


def camera_hooks(net, marks):
    """Synchronised marks '<name>>' / '<name><' (appended to `marks`, a
    dict of lists) around CaDDN's stages; returns the hooks."""
    def mark(name):
        def hook(*_):
            torch.cuda.synchronize()
            marks.setdefault(name, []).append(time.perf_counter())
        return hook

    mods = {'ddn': net.vfe.ddn, 'vfe': net.vfe, 'map_to_bev': net.map_to_bev,
            'backbone_2d': net.backbone_2d, 'dense_head': net.dense_head}
    if net.vfe.channel_reduce is not None:
        mods['channel_reduce'] = net.vfe.channel_reduce
    hooks = []
    for name, mod in mods.items():
        hooks += [mod.register_forward_pre_hook(mark(f'{name}>')),
                  mod.register_forward_hook(mark(f'{name}<'))]
    return hooks


def camera_spans(marks):
    """{stage: seconds} of CaDDN's forward from camera_hooks' marks."""
    def span(name):
        return marks[f'{name}<'][0] - marks[f'{name}>'][0]

    ddn = span('ddn') + (span('channel_reduce') if 'channel_reduce>' in marks
                         else 0.0)
    return {'depth network': ddn,
            'frustum volume + sampling': span('vfe') - ddn,
            'Conv2DCollapse': span('map_to_bev'),
            'BEV backbone': span('backbone_2d'),
            'dense head': span('dense_head')}


def camera_stage_times(det, batch):
    """CaDDN's synchronised stage wall times (ms) of one predict, and the
    predict's."""
    marks = {}
    hooks = camera_hooks(det.net, marks)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.predict(batch)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        for h in hooks:
            h.remove()
    spans = camera_spans(marks)
    spans['decode + final NMS'] = t_end - marks['dense_head<'][0]
    return {k: 1e3 * v for k, v in spans.items()}, 1e3 * (t_end - t0)


def _timed(module, attr, label, calls):
    """Shadow module.attr so that each call appends (label, start, end),
    synchronised; returns an undo function."""
    real = getattr(module, attr)
    own = attr in vars(module)       # a module's function, not a method

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((label, start, time.perf_counter()))
        return out

    setattr(module, attr, wrapped)
    return lambda: (setattr(module, attr, real) if own
                    else delattr(module, attr))


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
    print(f'{cfg.TAG} predict, B=2' + ('' if det.net.camera else
          f', test voxel budget {det.max_voxels_test}'))
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
    stage_times = (point_stage_times if det.point_based
                   else camera_stage_times if det.net.camera
                   else _stage_times)
    for batch in batches[1:]:
        spans, total = stage_times(det, batch)
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
