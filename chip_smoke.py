#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (glenet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. set-up: the card's name and power limit, torch / CUDA versions, and the
     build of every CUDA kernel of the port (one nvcc per source, all
     started together);
  2. full width, the main path: configs/kitti_models/GLENet_VR.yaml, one
     warm-up predict that captures the (ids, queries) of its merge-resolve
     calls, then 3 requests of B = 2 synthetic KITTI-like scenes of 32768
     points (random seeded weights, default dtypes), launches counted from
     0 over those requests;
  3. full width, the train step: the same detector trained with
     adam_onecycle over a full run's schedule (80 epochs x 928 iterations),
     B = BATCH_SIZE_PER_GPU = 4 synthetic training scenes with Car gt boxes
     and label variances, the train voxel budget; one warm-up step that
     captures its merge-resolve calls, then 3 timed steps, launches counted
     from 0 over those steps.  Per step: ms, every loss term, grad_norm,
     launches (4), peak memory; checks finite losses, changed parameters
     and BN running stats, and the LR / b1 of the one-cycle schedule;
  4. the CLIs, [cli]: a synthetic tree in KITTI's layout (16 train and 4
     val frames of 120k points over 360 degrees, 10-18 labelled cars each,
     KITTI's calibration, road planes) through the port's
     create_kitti_infos, with label variances written into its infos and
     gt database; then `python -m glenet_tpu_torch.tools.train` in process
     on GLENet_VR.yaml at full width, B = 4, 2 epochs x 2 steps, and a
     resume for a third epoch with --bn_refresh 2; then
     `glenet_tpu_torch.tools.test` on the newest checkpoint over the val
     frames.  Checks 3 checkpoints, the resumed step, a bit-exact reload,
     finite losses, 4 merge-resolve launches per train step and per
     predict, result.pkl and every Car_3d/*_R40 AP key, and the host
     library built from native/host_ops.cpp against its numpy versions on
     the tree.  Prints data ms and step ms per step (against the in-memory
     train steps of phase 3), peak memory, s/frame and the evaluation's
     own time;
  5. the label-uncertainty generator, [cvae]: (a) configs/cvae/exp_gen.yaml
     at full width (B = 64 crops of 512 points, LATENT_DIM 8) on a
     synthetic gt database of KITTI's train-split size (14357 Car + 1297
     Van crops), fold 0 of 10: one warm-up and 20 timed train steps (data
     ms split into crop loads / occlusion / the rest of the item,
     collation, copy; step ms; loss terms; grad_norm; lr / b1; peak
     memory), then one prediction pass over the val fold, and the
     projected wall time of the whole 10-fold run; (b) end to end on the
     [cli] tree: `glenet_tpu_torch.tools.cvae_train --folds 2 --passes 30
     --epochs 2 --inject` in process, the variance map and the _wconf
     infos checked, GLENet-VR trained on them through the train CLI (1
     epoch x 2 steps, B = 4, launches counted from 0 over it), and the
     analysis (in process and through `tools.cvae_analysis`) of fold 0's
     passes; (c) one Waymo train step and prediction pass
     (configs/cvae/waymo_exp_gen.yaml, 5-dim crops); (d) the card against
     the CPU: one train step (loss terms, gradients, BN stats, parameters
     after adam_onecycle) and one `sample`, same weights and eps;
  6. kernel check: every kernel equals its plain PyTorch version on
     adversarial cases (with the merge-resolve kernel's count of tiles on
     its wide-window path) and on the captured calls of the predict and of
     the train step; per call the kernel's device time (torch.profiler),
     back-to-back, host and cold-L2 times, the plain version's time, and
     torch.searchsorted's device and back-to-back times.  It runs after the
     main paths because a torch.profiler session leaves host overhead
     behind in the process, which slows every later step;
  7. GPU against CPU: the toy two-stage GLENet-VR topology, same seeded
     weights and points, f32 on both sides with TF32 off: a predict, and a
     train step with fixed RoI targets and DP_RATIO 0 (loss terms,
     gradients, BN running stats);
  8. one `{"kernels": [...]}` line; last line `{"ok": true, "device": ...}`.

Needs one CUDA device and the repository checkout around this file.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_REQUESTS, BATCH, N_POINTS = 3, 2, 32768
TRAIN_STEPS = 3
# the CLI phase's synthetic KITTI-layout tree and batch
CLI_TRAIN, CLI_VAL, CLI_POINTS, CLI_BATCH = 16, 4, 120_000, 4
KITTI_VAL_FRAMES = 3769
# the CVAE phase: KITTI's train-split gt database as OpenPCDet counts it
# (Car and Van, both taken with ENABLE_SIMILAR_TYPE), fold 0 of 10
CVAE_CARS, CVAE_VANS, CVAE_FOLDS, CVAE_PASSES = 14357, 1297, 10, 30
CVAE_STEPS = 20
WAYMO_CROPS = 640

# Toy two-stage GLENet-VR topology (MeanVFE -> VoxelBackBone8x ->
# BaseBEVBackbone -> AnchorHeadSingle -> VoxelRCNNKLLabelIoUHead), the
# model the port's CPU parity tests hold against glenet_tpu, on KITTI's z
# range so the BEV fold has depth 2 as at full width.
TINY_RANGE = (0, -8, -3, 16, 8, 1)
TINY_CFG = {
    'CLASS_NAMES': ['Car'],
    'DATA_CONFIG': {
        'POINT_CLOUD_RANGE': list(TINY_RANGE),
        'DATA_PROCESSOR': [{
            'NAME': 'transform_points_to_voxels',
            'VOXEL_SIZE': [0.5, 0.5, 0.1],
            'MAX_POINTS_PER_VOXEL': 5,
            'MAX_NUMBER_OF_VOXELS': {'train': 512, 'test': 512}}],
    },
    'MODEL': {
        'NAME': 'VoxelRCNN',
        'VFE': {'NAME': 'MeanVFE'},
        'BACKBONE_3D': {'NAME': 'VoxelBackBone8x'},
        'MAP_TO_BEV': {'NAME': 'HeightCompression', 'NUM_BEV_FEATURES': 256},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [2, 2],
                        'LAYER_STRIDES': [1, 2], 'NUM_FILTERS': [32, 64],
                        'UPSAMPLE_STRIDES': [1, 2],
                        'NUM_UPSAMPLE_FILTERS': [32, 32]},
        'DENSE_HEAD': {
            'NAME': 'AnchorHeadSingle', 'CLASS_AGNOSTIC': False,
            'USE_DIRECTION_CLASSIFIER': True, 'DIR_OFFSET': 0.78539,
            'DIR_LIMIT_OFFSET': 0.0, 'NUM_DIR_BINS': 2,
            'ANCHOR_GENERATOR_CONFIG': [{
                'class_name': 'Car', 'anchor_sizes': [[3.9, 1.6, 1.56]],
                'anchor_rotations': [0, 1.57],
                'anchor_bottom_heights': [-1.0], 'align_center': False,
                'feature_map_stride': 8, 'matched_threshold': 0.6,
                'unmatched_threshold': 0.45}],
            'TARGET_ASSIGNER_CONFIG': {'BOX_CODER': 'ResidualCoder'},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'cls_weight': 1.0, 'loc_weight': 2.0, 'dir_weight': 0.2,
                'code_weights': [1.0] * 7}},
        },
        'ROI_HEAD': {
            'NAME': 'VoxelRCNNKLLabelIoUHead', 'CLASS_AGNOSTIC': True,
            'SHARED_FC': [32, 32], 'CLS_FC': [32], 'REG_FC': [32],
            'DP_RATIO': 0.3,
            'NMS_CONFIG': {
                'TRAIN': {'NMS_TYPE': 'nms_gpu', 'NMS_PRE_MAXSIZE': 512,
                          'NMS_POST_MAXSIZE': 64, 'NMS_THRESH': 0.8},
                'TEST': {'NMS_TYPE': 'nms_gpu', 'NMS_PRE_MAXSIZE': 256,
                         'NMS_POST_MAXSIZE': 32, 'NMS_THRESH': 0.7,
                         'SCORE_THRESH': 0.0}},
            'ROI_GRID_POOL': {
                'FEATURES_SOURCE': ['x_conv2', 'x_conv3', 'x_conv4'],
                'GRID_SIZE': 4,
                'POOL_LAYERS': {'x_conv2': {'MLPS': [[16, 16]]},
                                'x_conv3': {'MLPS': [[16, 16]]},
                                'x_conv4': {'MLPS': [[16, 16]]}}},
            'TARGET_CONFIG': {
                'BOX_CODER': 'ResidualCoder', 'ROI_PER_IMAGE': 32,
                'FG_RATIO': 0.5, 'SAMPLE_ROI_BY_EACH_CLASS': True,
                'CLS_SCORE_TYPE': 'roi_iou', 'CLS_FG_THRESH': 0.75,
                'CLS_BG_THRESH': 0.25, 'CLS_BG_THRESH_LO': 0.1,
                'HARD_BG_RATIO': 0.8, 'REG_FG_THRESH': 0.55},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'rcnn_cls_weight': 1.0, 'rcnn_reg_weight': 1.0,
                'rcnn_corner_weight': 1.0, 'code_weights': [1.0] * 7}},
        },
        'POST_PROCESSING': {
            'SCORE_THRESH': 0.1,
            'NMS_CONFIG': {'MULTI_CLASSES_NMS': False,
                           'NMS_TYPE': 'new_nms_gpu', 'NMS_THRESH': 0.1,
                           'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 32}},
    },
    'OPTIMIZATION': {
        'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': 1, 'OPTIMIZER': 'adam_onecycle',
        'LR': 0.003, 'WEIGHT_DECAY': 0.01, 'MOMS': [0.95, 0.85],
        'PCT_START': 0.4, 'DIV_FACTOR': 10, 'GRAD_NORM_CLIP': 10},
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def tiny_batch(seed, b=2, n_points=1024):
    import numpy as np
    x0, y0, z0, x1, y1, z1 = TINY_RANGE
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n_points, 4), np.float32)
    pts[..., 0] = rng.uniform(x0, x1, (b, n_points))
    pts[..., 1] = rng.uniform(y0, y1, (b, n_points))
    pts[..., 2] = rng.uniform(z0 + 0.1, z1 - 0.1, (b, n_points))
    pts[..., 3] = rng.uniform(0, 1, (b, n_points))
    return pts


def phase_setup(kernels):
    import torch

    from glenet_tpu_torch.ops import cuda_lib
    from glenet_tpu_torch.utils.cuda_timing import card_line
    line = card_line()
    print(f'[setup] card: {line}')
    print(f'[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'device {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    logs = cuda_lib.build_all(kernels, verbose=True)
    print(f'[setup] built {len(kernels)} kernel(s) in '
          f'{time.perf_counter() - t0:.2f} s')
    for name, log in logs.items():
        for ln in log.splitlines():
            if 'registers' in ln or 'spill' in ln:
                print(f'[setup] {name}: {ln.strip()}')
    return line


def adversarial_merge_cases():
    import torch
    g = torch.Generator().manual_seed(SEED)

    def srt(t, dim=-1):
        return torch.sort(t, dim=dim).values.to(torch.int32)

    def rand(lo, hi, shape):
        return srt(torch.randint(lo, hi, shape, generator=g))

    cases = {}
    ids = rand(0, 5000, (2, 700))
    cases['random'] = (ids, rand(-10, 5100, (2, 9, 900)))
    cases['all_sentinel'] = (torch.full((2, 512), 1000, dtype=torch.int32),
                             rand(0, 1001, (2, 3, 600)))
    ids = rand(10_000, 20_000, (1, 4000))
    cases['below_table'] = (ids, rand(0, 12_000, (1, 9, 3000)))
    ids = rand(0, 90_000_000, (2, 5000))
    cases['negative_raw'] = (ids, rand(-2_000_000, 90_000_100, (2, 9, 5000)))
    v = (1 << 20) - 1
    ids = rand(0, 1 << 26, (1, v))
    cases['v_near_2^20'] = (ids, rand(-5, (1 << 26) + 5, (1, 9, 200_000)))
    # windows far wider than the kernel's shared buffer
    ids = rand(0, 1 << 26, (2, 1_000_000))
    cases['wide_windows'] = (ids, rand(-5, (1 << 26) + 5, (2, 3, 3000)))
    # ragged last tile (Vq not a multiple of the kernel's tile)
    ids = rand(0, 20_000, (2, 5000))
    cases['ragged_vq'] = (ids, rand(-3, 20_003, (2, 9, 5001)))
    cases['vq_1'] = (rand(0, 5000, (2, 700)), rand(-10, 5010, (2, 9, 1)))
    cases['v_1'] = (torch.tensor([[40], [7]], dtype=torch.int32),
                    rand(0, 50, (2, 3, 3000)))
    ids = rand(0, 1000, (2, 3000))
    eq = torch.stack([ids[:, 1500], ids[:, 1500] + 1, ids[:, 0] - 5,
                      ids[:, -1] + 7], dim=1)                     # (2, 4)
    cases['equal_queries'] = (ids, eq[:, :, None].expand(2, 4, 4100)
                              .contiguous())
    n_cells = 1_000_000
    ids = torch.cat([rand(0, n_cells, (2, 10_000)),
                     torch.full((2, 30_000), n_cells, dtype=torch.int32)], 1)
    cases['sentinel_runs'] = (ids, rand(-2, n_cells + 6, (2, 9, 40_000)))
    ids = rand(0, 50_000, (2, 8000))
    cases['past_table'] = (ids, rand(50_000, 1 << 30, (2, 9, 6000)))
    cases['below_all'] = (ids, rand(-(1 << 30), 0, (2, 9, 6000)))
    ids = rand(0, 200_000, (1, 50_000))
    cases['b1_g1'] = (ids, rand(-5, 200_005, (1, 1, 60_000)))
    return cases


def max_abs_err(got, ref):
    return max(int((a.long() - b.long()).abs().max()) for a, b in
               zip(got, ref))


def check_captured(captured, what):
    """Kernel == plain on the 4 captured calls of one predict or train step;
    their summed times."""
    from glenet_tpu_torch.bench_merge import CALL_NAMES, fmt, measure_call
    from glenet_tpu_torch.ops import merge_kernel as mk
    from glenet_tpu_torch.utils import cuda_timing as ct
    check(len(captured) == 4, f'expected 4 table builds per {what}, saw '
                              f'{len(captured)}')
    keys = ('ms', 'device_ms', 'host_ms', 'cold_ms', 'plain_ms',
            'library_ms', 'library_device_ms', 'bound_ms')
    tot = dict.fromkeys(keys, 0.0)
    bound_by = set()
    for name, (ids, q) in zip(CALL_NAMES, captured):
        got, wide, glob = mk.resolve_sorted_queries_counted(ids, q)
        err = max_abs_err(got, mk.resolve_sorted_queries_plain(ids, q))
        check(err == 0, f'merge_resolve differs on captured {what} call '
                        f'{name}')
        r = measure_call(ids, q)
        r['plain_ms'] = ct.event_ms(
            lambda: mk.resolve_sorted_queries_plain(ids, q))
        bound_by.add(r['bound_by'])
        print(f'[kernel] merge_resolve {what} {name}: ids '
              f'{tuple(ids.shape)} queries {tuple(q.shape)} max_abs_err '
              f'{err}, wide tiles {wide} (global groups {glob}); kernel '
              f'device {fmt(r["device_ms"])} ms, back-to-back '
              f'{fmt(r["ms"])}, host {fmt(r["host_ms"])}, cold '
              f'{fmt(r["cold_ms"])}; plain {fmt(r["plain_ms"])}; '
              f'torch.searchsorted (pos only) device '
              f'{fmt(r["library_device_ms"])}, back-to-back '
              f'{fmt(r["library_ms"])}; bound {r["bound_ms"]:.4f} '
              f'({r["bound_by"]})')
        for k in keys:
            tot[k] = None if tot[k] is None or r[k] is None else tot[k] + r[k]
    print(f'[kernel] merge_resolve per {what} (4 calls): ' + ', '.join(
        f'{k} {fmt(v)}' for k, v in tot.items()))
    return {'bound_by': '/'.join(sorted(bound_by)), **tot}


def phase_merge_check(captured, captured_train):
    """Kernel == plain on adversarial and captured cases; times."""
    from glenet_tpu_torch.ops import merge_kernel as mk
    max_err, n_wide, n_global = 0, 0, 0
    for name, (ids, q) in adversarial_merge_cases().items():
        ids, q = ids.cuda(), q.cuda()
        got, wide, glob = mk.resolve_sorted_queries_counted(ids, q)
        err = max_abs_err(got, mk.resolve_sorted_queries_plain(ids, q))
        print(f'[kernel] merge_resolve {name}: ids {tuple(ids.shape)} '
              f'queries {tuple(q.shape)} max_abs_err {err}, tiles on the '
              f'wide-window path {wide} (query groups from global memory '
              f'{glob})')
        check(err == 0, f'merge_resolve differs from its plain version on '
                        f'{name}')
        max_err = max(max_err, err)
        n_wide, n_global = n_wide + wide, n_global + glob
    check(n_wide > 0 and n_global > 0,
          'the adversarial cases missed a path of the kernel')
    return {'max_abs_err': max_err, **check_captured(captured, 'predict'),
            'train': check_captured(captured_train, 'train step')}


def phase_gpu_vs_cpu():
    """Tiny two-stage topology on the card and on the port's CPU path."""
    import torch

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.models import spconv_backbone
    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.utils.synthetic import seeded_detector
    cfg = Cfg(TINY_CFG)
    saved = (sparse.GATHER_COMPUTE_DTYPE, spconv_backbone.DENSE_MXU_DTYPE,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    sparse.GATHER_COMPUTE_DTYPE = None
    spconv_backbone.DENSE_MXU_DTYPE = None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pts = torch.from_numpy(tiny_batch(SEED + 7))
        mask = torch.ones(pts.shape[:2], dtype=torch.bool)
        outs = {}
        for dev in ('cpu', 'cuda'):
            det = seeded_detector(cfg, dev, SEED + 3)
            with torch.no_grad():
                full = det.net(pts.to(dev), mask.to(dev))
                pred = det.finalize(full)
            outs[dev] = (full, pred)
    finally:
        (sparse.GATHER_COMPUTE_DTYPE, spconv_backbone.DENSE_MXU_DTYPE,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    (fc, pc), (fg, pg) = outs['cpu'], outs['cuda']
    # f32 on both devices, convolutions and sums in another order:
    # features rtol 1e-3 / atol 1e-4, final boxes and scores atol 1e-3
    exact = [('voxel_coords', fc['vox']['voxel_coords'],
              fg['vox']['voxel_coords']),
             ('roi_valid', fc['proposals']['roi_valid'],
              fg['proposals']['roi_valid']),
             ('final_valid', pc['final_valid'], pg['final_valid']),
             ('final_labels', pc['final_labels'], pg['final_labels'])]
    for name, a, b in exact:
        check(torch.equal(a, b.cpu()), f'GPU and CPU differ in {name}')
    close = [('bev_features', fc['backbone_3d']['bev_features'],
              fg['backbone_3d']['bev_features'], 1e-3, 1e-4),
             ('rcnn_reg', fc['rcnn']['rcnn_reg'], fg['rcnn']['rcnn_reg'],
              1e-3, 1e-4),
             ('final_boxes', pc['final_boxes'], pg['final_boxes'], 0, 1e-3),
             ('final_scores', pc['final_scores'], pg['final_scores'], 0,
              1e-3)]
    for name, a, b, rtol, atol in close:
        err = float((a - b.cpu()).abs().max())
        ok = torch.allclose(a, b.cpu().to(a.dtype), rtol=rtol, atol=atol)
        print(f'[gpu-vs-cpu] {name}: max_abs_err {err:.3e} '
              f'(rtol {rtol}, atol {atol})')
        check(ok, f'GPU and CPU differ in {name}')
    n_valid = int(pc['final_valid'].sum())
    print(f'[gpu-vs-cpu] tiny two-stage predict: integer outputs equal, '
          f'{n_valid} valid final boxes')


def tiny_train_batch(cfg):
    """The toy training batch: tiny_batch's points, gt boxes 0.15 m off the
    first 4 valid proposals of each sample of a CPU predict (so the RoI
    targets hold foreground), label variances in [0.02, 0.3), and fixed RoI
    targets sampled once on the CPU."""
    import numpy as np
    import torch

    from glenet_tpu_torch.utils.synthetic import seeded_detector
    pts = torch.from_numpy(tiny_batch(SEED + 7))
    b = pts.shape[0]
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    det = seeded_detector(cfg, 'cpu', SEED + 3)
    with torch.no_grad():
        prop = det.net(pts, mask)['proposals']
    gt = torch.zeros((b, 8, 8))
    gt_mask = torch.zeros((b, 8), dtype=torch.bool)
    for i in range(b):
        idx = torch.nonzero(prop['roi_valid'][i]).flatten()[:4]
        gt[i, :len(idx), :7] = prop['rois'][i, idx]
        gt[i, :len(idx), 0] += 0.15
        gt[i, :len(idx), 7] = 1
        gt_mask[i, :len(idx)] = True
    unc = np.random.RandomState(SEED + 11).uniform(0.02, 0.3, (b, 8, 7))
    batch = {'points': pts, 'points_mask': mask, 'gt_boxes': gt,
             'gt_mask': gt_mask,
             'gt_uncertainty': torch.from_numpy(unc.astype(np.float32))}
    with torch.no_grad():
        out = det.net(pts, mask, train=True, gt_boxes=gt, gt_mask=gt_mask,
                      gt_uncertainty=batch['gt_uncertainty'],
                      generator=torch.Generator().manual_seed(SEED))
    batch['roi_targets'] = out['roi_targets']
    return batch


def phase_gpu_vs_cpu_train():
    """One toy train step (fixed RoI targets, DP_RATIO 0) on the card and
    on the port's CPU path."""
    import copy

    import torch

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.models import spconv_backbone
    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.train import optim, state as st
    from glenet_tpu_torch.utils.synthetic import seeded_detector
    raw = copy.deepcopy(TINY_CFG)
    raw['MODEL']['ROI_HEAD']['DP_RATIO'] = 0.0
    cfg = Cfg(raw)
    saved = (sparse.GATHER_COMPUTE_DTYPE, spconv_backbone.DENSE_MXU_DTYPE,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    sparse.GATHER_COMPUTE_DTYPE = None
    spconv_backbone.DENSE_MXU_DTYPE = None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch = tiny_train_batch(cfg)
        n_fg = int(batch['roi_targets']['reg_valid_mask'].sum())
        check(n_fg > 0, 'the toy RoI targets hold no foreground')
        runs = {}
        for dev in ('cpu', 'cuda'):
            det = seeded_detector(cfg, dev, SEED + 3)
            tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
            state = st.create_train_state(det, tx)
            bt = {k: (v.to(dev) if torch.is_tensor(v)
                      else {kk: vv.to(dev) for kk, vv in v.items()})
                  for k, v in batch.items()}
            state, metrics = st.make_train_step(det, tx)(state, bt)
            runs[dev] = (metrics, det.net, tx)
    finally:
        (sparse.GATHER_COMPUTE_DTYPE, spconv_backbone.DENSE_MXU_DTYPE,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    (mc, nc, tx), (mg, ng, _) = runs['cpu'], runs['cuda']
    # f32 on both devices, TF32 off.  Loss terms rtol 1e-4.  Gradients:
    # atomics in the backward of the row gathers and the corner gathers
    # (index_add_ / scatter-add) and the strided convs, and cuDNN's
    # convolution backward, sum in another order: per parameter max |diff|
    # <= 1e-3 * max |grad| + 1e-6.  BN running stats rtol 1e-4 / atol 1e-5.
    # Parameters after one Adam step: each element moves by about
    # lr * sign(grad), so an element whose gradient is at rounding level may
    # move either way: max |diff| <= 2 lr + 1e-6.
    for k, v in mc.items():
        err = abs(float(mg[k].cpu()) - float(v))
        check(err <= 1e-4 * abs(float(v)) + 1e-6,
              f'GPU and CPU differ in {k}: {float(mg[k])} vs {float(v)}')
    print('[gpu-vs-cpu] train step loss terms: ' + ', '.join(
        f'{k} {float(v):.6f}' for k, v in sorted(mc.items())))
    worst = 0.0
    gpu_params = dict(ng.named_parameters())
    for name, p in nc.named_parameters():
        g_c = p.grad if p.grad is not None else torch.zeros_like(p)
        pg = gpu_params[name]
        g_g = (pg.grad if pg.grad is not None else torch.zeros_like(pg)).cpu()
        err = float((g_c - g_g).abs().max())
        tol = 1e-3 * float(g_c.abs().max()) + 1e-6
        check(err <= tol, f'GPU and CPU gradients differ in {name}: '
                          f'{err:.3e} > {tol:.3e}')
        worst = max(worst, err / tol)
        step_err = float((p.detach() - pg.detach().cpu()).abs().max())
        lr = tx.hyperparams(0)[0]
        check(step_err <= 2 * lr + 1e-6,
              f'GPU and CPU parameters differ after the step in {name}')
    gpu_bufs = dict(ng.named_buffers())
    for name, buf in nc.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            check(torch.allclose(buf, gpu_bufs[name].cpu(), rtol=1e-4,
                                 atol=1e-5),
                  f'GPU and CPU BN running stats differ in {name}')
    print(f'[gpu-vs-cpu] tiny train step: {n_fg} foreground RoIs; loss '
          f'terms within rtol 1e-4, every gradient within its tolerance '
          f'(worst at {worst:.2f} of it), BN running stats and the '
          f'parameters after adam_onecycle agree')


def prepare_full_width():
    """GLENet_VR.yaml at full width on the card: seeded detector, the
    requests' scenes, and one warm-up predict that captures the inputs of
    the four merge-resolve calls."""
    from glenet_tpu_torch.bench_merge import capture_calls
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.utils.synthetic import scene_batches, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    det = seeded_detector(cfg, 'cuda', SEED)
    batches = scene_batches(N_REQUESTS + 1, SEED, BATCH)
    t0 = time.perf_counter()
    captured = capture_calls(lambda: det.predict(batches[0]))[0]
    print(f'[kernel] warm-up full-width predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    return cfg, det, batches[1:], captured


def watch_sites(det, sites):
    """Record the active sites of each backbone level of every forward in
    `sites`; returns the hook's handle."""
    def record(_mod, _inp, out):
        ms = out['multi_scale']
        sites.update({
            'x_conv1': ms['x_conv1']['mask'].sum(1),
            'x_conv2': ms['x_conv2']['mask'].sum(1),
            'x_conv3': ms['x_conv3']['mask'].sum(1),
            'x_conv4': ms['x_conv4']['occ'].flatten(1).sum(1)})

    return det.net.backbone_3d.register_forward_hook(record)


def sites_line(sites, caps):
    """'x_conv1 [n, ...]/cap, ...': active sites per sample against the
    level caps of the sparse levels."""
    return ', '.join(
        f'{k} {sites[k].tolist()}' + (f'/{caps[i]}' if i < 3 else '')
        for i, k in enumerate(('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')))


def phase_full_width(det, batches):
    """The main path: N_REQUESTS predicts, merge-resolve launches counted
    from 0 just before and read just after."""
    import torch

    from glenet_tpu_torch.ops import merge_kernel as mk
    from glenet_tpu_torch.ops import sparse
    caps = sparse.level_caps(det.max_voxels_test)
    sites = {}

    def record_proposals(_mod, _inp, out):
        sites['proposals'] = out['proposals']['roi_valid'].sum(1)

    hooks = [watch_sites(det, sites),
             det.net.register_forward_hook(record_proposals)]
    times, per_request = [], []
    mk.LAUNCHES = 0
    for r, batch in enumerate(batches):
        before = mk.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = det.predict(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        per_request.append((pred, mk.LAUNCHES - before,
                            torch.cuda.max_memory_allocated(), dict(sites)))
    launches = mk.LAUNCHES
    for h in hooks:
        h.remove()
    for r, (pred, n_launch, mem, st) in enumerate(per_request):
        for k, shape in (('final_boxes', (BATCH, 500, 7)),
                         ('final_scores', (BATCH, 500))):
            check(tuple(pred[k].shape) == shape,
                  f'{k} shape {tuple(pred[k].shape)}')
            check(bool(torch.isfinite(pred[k]).all()), f'{k} not finite')
        check(n_launch == 4, f'request {r}: {n_launch} merge-resolve '
                             f'launches, expected 4')
        lvl = sites_line(st, caps)
        print(f'[full] request {r}: {times[r]:.1f} ms; active sites {lvl}; '
              f'valid proposals {st["proposals"].tolist()}; valid final '
              f'boxes {pred["final_valid"].sum(1).tolist()}; '
              f'merge_resolve launches {n_launch}; max_memory_allocated '
              f'{mem / 2**30:.2f} GiB')
    print(f'[full] GLENet-VR predict B={BATCH} x {N_POINTS} points: '
          f'mean {sum(times) / len(times):.1f} ms over {len(times)} requests')
    return launches


def onecycle_expected(opt_cfg, n_total, count):
    """(lr, b1) of the update after `count` updates, written out from the
    fastai OneCycle schedule: cosine from LR / DIV_FACTOR up to LR and b1
    from MOMS[0] down to MOMS[1] over PCT_START of the steps, then back."""
    import math
    lr_max, div = float(opt_cfg.LR), float(opt_cfg.DIV_FACTOR)
    m0, m1 = (float(m) for m in opt_cfg.MOMS)
    split = int(n_total * float(opt_cfg.PCT_START))

    def cos(a, b, pct):
        return b + (a - b) / 2 * (math.cos(math.pi * pct) + 1)

    if count < split:
        pct = count / split
        return cos(lr_max / div, lr_max, pct), cos(m0, m1, pct)
    pct = min((count - split) / (n_total - split), 1.0)
    return cos(lr_max, lr_max / div / 1e4, pct), cos(m1, m0, pct)


def phase_train(cfg, det):
    """The train step at full width: a warm-up step that captures the
    merge-resolve calls, then TRAIN_STEPS timed steps with the launches
    counted from 0 just before and read just after."""
    import math

    import torch

    from glenet_tpu_torch.bench_merge import capture_calls
    from glenet_tpu_torch.ops import merge_kernel as mk
    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.profile_train import build_training, total_steps
    from glenet_tpu_torch.utils.synthetic import train_batches
    opt_cfg = cfg.OPTIMIZATION
    caps = sparse.level_caps(det.max_voxels_train)
    b = int(opt_cfg.BATCH_SIZE_PER_GPU)
    n_total = total_steps(opt_cfg)
    tx, state, train_step = build_training(cfg, det)
    batches = train_batches(TRAIN_STEPS + 1, SEED + 1, b)
    n_gt = batches[0]['gt_mask'].sum(1).tolist()
    t0 = time.perf_counter()
    captured, (state, metrics) = capture_calls(
        lambda: train_step(state, batches[0]))
    print(f'[train] GLENet-VR train step, B={b} x {N_POINTS} points, train '
          f'voxel budget {det.max_voxels_train}, gt boxes {n_gt}, '
          f'adam_onecycle total_steps {n_total} ({opt_cfg.NUM_EPOCHS} epochs x '
          f'{n_total // int(opt_cfg.NUM_EPOCHS)} iterations); warm-up step '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms, loss '
          f'{float(metrics["loss"]):.4f}')
    params = {n: p.detach().clone() for n, p in det.net.named_parameters()}
    stats = {n: t.clone() for n, t in det.net.named_buffers()
             if n.endswith(('running_mean', 'running_var'))}
    times, sites = [], {}
    hook = watch_sites(det, sites)
    mk.LAUNCHES = 0
    for i, batch in enumerate(batches[1:]):
        before = mk.LAUNCHES
        count = state.opt_state['count']
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        n_launch = mk.LAUNCHES - before
        peak = torch.cuda.max_memory_allocated()
        vals = {k: float(v) for k, v in metrics.items()}
        for k, v in vals.items():
            check(math.isfinite(v), f'train step {i}: {k} = {v}')
        check(n_launch == 4, f'train step {i}: {n_launch} merge-resolve '
                             f'launches, expected 4')
        lr, b1 = state.opt_state['hyperparams']
        lr_x, b1_x = onecycle_expected(opt_cfg, n_total, count)
        check(abs(lr - lr_x) <= 1e-9 * lr_x and abs(b1 - b1_x) <= 1e-9,
              f'train step {i}: lr {lr}, b1 {b1}; the schedule gives '
              f'{lr_x}, {b1_x}')
        print(f'[train] step {i}: {times[-1]:.1f} ms; ' + ', '.join(
            f'{k} {v:.5f}' for k, v in sorted(vals.items()))
            + f'; lr {lr:.6e}, b1 {b1:.6f} (update {count + 1}); '
              f'active sites {sites_line(sites, caps)}; merge_resolve '
              f'launches {n_launch}; max_memory_allocated '
              f'{peak / 2**30:.2f} GiB')
    launches = mk.LAUNCHES
    hook.remove()
    # adam_onecycle moves every parameter except one that is zero with zero
    # gradients (weight decay keeps it at zero)
    still = [n for n, p in det.net.named_parameters()
             if torch.equal(p.detach(), params[n])]
    stuck = [n for n, p in det.net.named_parameters() if n in still and (
        bool(p.detach().any()) or (p.grad is not None and bool(p.grad.any())))]
    check(not stuck, f'parameters unchanged by {TRAIN_STEPS} steps: {stuck}')
    bufs = dict(det.net.named_buffers())
    same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
    check(not same, f'BN running stats unchanged by {TRAIN_STEPS} steps: '
                    f'{same}')
    print(f'[train] {TRAIN_STEPS} steps: mean {sum(times) / len(times):.1f} '
          f'ms; {len(params) - len(still)} of {len(params)} parameter '
          f'tensors changed (unchanged, zero with zero gradients: {still}), '
          f'all {len(stats)} BN running-stat tensors changed; lr and b1 on '
          f'the one-cycle schedule')
    return launches, captured, times


def count_launches(obj, attr, counts):
    """Shadow obj.attr (a train-step factory or a predict method) so that
    each call it makes appends its merge-resolve launches to `counts`;
    returns an undo function."""
    from glenet_tpu_torch.ops import merge_kernel as mk
    real = getattr(obj, attr)

    def counted(fn):
        def call(*args, **kwargs):
            before = mk.LAUNCHES
            out = fn(*args, **kwargs)
            counts.append(mk.LAUNCHES - before)
            return out
        return call

    if attr == 'make_train_step':
        setattr(obj, attr, lambda *a, **k: counted(real(*a, **k)))
    else:
        setattr(obj, attr, counted(real))
    return lambda: setattr(obj, attr, real)


_TIMED = []                               # inner seconds of the open calls


def time_calls(obj, attr, totals, key):
    """Shadow obj.attr so that totals[key] adds the host seconds of its
    calls, less those of other shadowed calls made inside them, and
    totals[key + ' n'] counts them; returns an undo function."""
    raw = vars(obj)[attr]                 # a staticmethod stays one
    real = getattr(obj, attr)

    def call(*args, **kwargs):
        _TIMED.append(0.0)
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            totals[key] = totals.get(key, 0.0) + dt - _TIMED.pop()
            totals[key + ' n'] = totals.get(key + ' n', 0) + 1
            if _TIMED:
                _TIMED[-1] += dt

    setattr(obj, attr,
            staticmethod(call) if isinstance(raw, staticmethod) else call)
    return lambda: setattr(obj, attr, raw)


def synthetic_detections(gt_annos, rng, n_false=20):
    """Detections for KITTI annos: each labelled object jittered by one of
    several offsets (IoU levels), and `n_false` false positives per frame,
    all with random scores."""
    import numpy as np
    dts = []
    for g in gt_annos:
        keep = g['name'] != 'DontCare'
        n, k = int(keep.sum()), int(keep.sum()) + n_false
        sigma = rng.choice([0.05, 0.2, 0.5], n)[:, None]
        loc = np.concatenate([g['location'][keep] + rng.normal(0, 1, (n, 3))
                              * sigma,
                              np.stack([rng.uniform(-20, 20, n_false),
                                        np.full(n_false, 1.6),
                                        rng.uniform(5, 70, n_false)], 1)])
        dims = np.concatenate([g['dimensions'][keep],
                               np.tile([3.9, 1.56, 1.6], (n_false, 1))])
        ry = np.concatenate([g['rotation_y'][keep] + rng.normal(0, 0.1, n),
                             rng.uniform(-np.pi, np.pi, n_false)])
        x1 = rng.uniform(0, 1100, n_false)
        y1 = rng.uniform(150, 250, n_false)
        bbox = np.concatenate([g['bbox'][keep] + rng.normal(0, 4, (n, 4)),
                               np.stack([x1, y1, x1 + 60, y1 + 45], 1)])
        dts.append({'name': np.array(['Car'] * k), 'bbox': bbox,
                    'location': loc, 'dimensions': dims, 'rotation_y': ry,
                    'alpha': ry + rng.normal(0, 0.1, k),
                    'truncated': np.zeros(k), 'occluded': np.zeros(k),
                    'score': rng.uniform(0, 1, k)})
    return dts


def phase_eval(root, cfg):
    """The KITTI evaluation on the card: against its CPU run on the tree's
    20 labelled frames with synthetic detections, then timed at the size of
    KITTI's val split (3769 frames, the 20 repeated), in parts: clean_data
    (host), the rotated BEV / 3D overlaps (card), and the rest (the
    matcher's two stages per cell on the card, the curves)."""
    import pickle

    import numpy as np
    import torch

    from glenet_tpu_torch.eval import kitti_eval as ke
    gt = []
    for split in ('train', 'val'):
        with open(root / f'kitti_infos_{split}.pkl', 'rb') as f:
            gt += [info['annos'] for info in pickle.load(f)]
    dt = synthetic_detections(gt, np.random.RandomState(SEED))
    (s_gpu, r_gpu), (s_cpu, r_cpu) = (
        ke.get_official_eval_result(gt, dt, cfg.CLASS_NAMES, device=d)
        for d in ('cuda', 'cpu'))
    err = max(abs(r_gpu[k] - r_cpu[k]) for k in r_cpu)
    check(set(r_gpu) == set(r_cpu) and err <= 1e-3 and s_gpu == s_cpu,
          f'KITTI evaluation differs between the card and the CPU ({err})')
    moderate = r_gpu['Car_3d/moderate_R40']
    check(0 < moderate < 100, f'Car_3d/moderate_R40 {moderate}')
    print(f'[eval] KITTI evaluation of {len(gt)} frames with synthetic '
          f'detections: card equals CPU (every AP within {err:.1e}, result '
          f'strings equal), Car_3d/moderate_R40 {moderate:.2f}')

    reps = -(-KITTI_VAL_FRAMES // len(gt))
    gt, dt = (gt * reps)[:KITTI_VAL_FRAMES], (dt * reps)[:KITTI_VAL_FRAMES]
    times = {}
    for name, fn in (
            ('clean_data', lambda: [ke.clean_data(g, d, 0, diff)
                                    for _ in range(6) for diff in range(3)
                                    for g, d in zip(gt, dt)]),
            ('overlaps', lambda: [ke.frame_overlaps(gt, dt, m, 'cuda')
                                  for m in range(3)]),
            ('evaluation', lambda: ke.get_official_eval_result(
                gt, dt, cfg.CLASS_NAMES, device='cuda'))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    rest = times['evaluation'] - times['overlaps'] - times['clean_data']
    n_gt = sum(len(a['name']) for a in gt)
    n_dt = sum(len(a['name']) for a in dt)
    print(f'[eval] KITTI evaluation at the size of the val split, '
          f'{len(gt)} frames ({n_gt} labels, {n_dt} detections): '
          f'{times["evaluation"]:.3f} s = clean_data for the 18 cells '
          f'{times["clean_data"]:.3f} s (host) + rotated overlaps of the 3 '
          f'metrics {times["overlaps"]:.3f} s (card) + the matcher\'s 2 '
          f'stages x 18 cells and the curves {rest:.3f} s')


def check_host_library(root):
    """The host library is the one built from native/host_ops.cpp, and it
    equals its numpy versions on the tree's boxes and points."""
    import pickle

    import numpy as np

    from glenet_tpu_torch.ops import host_ops
    lib = host_ops.load()
    check(host_ops.SOURCE == ROOT / 'native' / 'host_ops.cpp'
          and lib._name == str(host_ops.library_path()),
          f'host library {lib._name} is not the one built from '
          f'{host_ops.SOURCE}')
    with open(root / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    boxes = np.concatenate([i['annos']['gt_boxes_lidar'] for i in infos])
    n_pts, t_lib, t_np, n_inside = 0, 0.0, 0.0, 0
    for info in infos[:4]:
        pts = np.fromfile(str(root / 'training/velodyne' /
                              f"{info['point_cloud']['lidar_idx']}.bin"),
                          np.float32).reshape(-1, 4)
        t0 = time.perf_counter()
        got = host_ops.points_in_rboxes(pts, boxes)
        t1 = time.perf_counter()
        ref = host_ops.points_in_rboxes_plain(pts, boxes)
        t_lib, t_np = t_lib + t1 - t0, t_np + time.perf_counter() - t1
        check(np.array_equal(got, ref), 'points_in_rboxes differs from its '
                                        'numpy version')
        n_pts, n_inside = n_pts + len(pts), n_inside + int(got.sum())
    rng = np.random.RandomState(SEED)
    many = np.concatenate([boxes, boxes + rng.uniform(-3, 3, boxes.shape)
                           * [1, 1, 0, 0, 0, 0, 1]]).astype(np.float32)
    got = host_ops.rbox_collision(many, many)
    check(np.array_equal(got, host_ops.rbox_collision_plain(many, many)),
          'rbox_collision differs from its numpy version')
    print(f'[cli] host library {Path(lib._name).name} (built from '
          f'native/host_ops.cpp): points_in_rboxes equals numpy on '
          f'{n_pts} points x {len(boxes)} boxes ({n_inside} inside; '
          f'{1e3 * t_lib:.1f} ms against numpy {1e3 * t_np:.1f} ms); '
          f'rbox_collision equals numpy on {len(many)}^2 pairs '
          f'({int(got.sum())} overlapping)')


def phase_cli(in_memory_ms, tmp):
    """The train and test CLIs end to end on a synthetic KITTI-layout tree
    at full width, written under `tmp`; merge-resolve launches counted from
    0 just before and read just after.  Returns the launches and the
    tree's root."""
    import math
    import pickle

    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets import augmentor
    from glenet_tpu_torch.datasets.kitti_dataset import (KittiDataset,
                                                         create_kitti_infos)
    from glenet_tpu_torch.models.detectors import Detector, build_detector
    from glenet_tpu_torch.ops import merge_kernel as mk
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.train import checkpoint as ck
    from glenet_tpu_torch.train import state as state_lib
    from glenet_tpu_torch.utils import synthetic
    cfg_file = str(ROOT / 'configs/kitti_models/GLENet_VR.yaml')
    cfg = cfg_from_yaml_file(cfg_file)
    root, out = tmp / 'kitti', tmp / 'out'
    t0 = time.perf_counter()
    synthetic.write_kitti_tree(root, CLI_TRAIN, CLI_VAL, seed=SEED,
                               n_points=CLI_POINTS)
    t1 = time.perf_counter()
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    synthetic.add_label_variances(root, seed=SEED)
    t2 = time.perf_counter()
    with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
        n_db = len(pickle.load(f)['Car'])
    print(f'[cli] synthetic KITTI tree: {CLI_TRAIN} train + {CLI_VAL} val '
          f'frames of {CLI_POINTS} points written in {t1 - t0:.1f} s; '
          f'create_kitti_infos and label variances {t2 - t1:.1f} s, '
          f'{n_db} Car objects in the gt database')
    check_host_library(root)

    common = ['--cfg_file', cfg_file, '--data_path', str(root),
              '--output_dir', str(out), '--batch_size', str(CLI_BATCH),
              '--max_steps_per_epoch', '2']
    step_launches, predict_launches, data = [], [], {}
    undo = [count_launches(state_lib, 'make_train_step', step_launches),
            count_launches(Detector, 'predict', predict_launches)]
    timers = [time_calls(KittiDataset, '__getitem__', data, 'items'),
              time_calls(augmentor.DataAugmentor, '__call__', data,
                         'augment'),
              time_calls(augmentor.DataBaseSampler, '__call__', data,
                         'gt_sampling'),
              time_calls(KittiDataset, 'collate_batch', data, 'collate'),
              time_calls(train_cli, 'to_device', data, 'copy')]
    mk.LAUNCHES = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        first = train_cli.main(common + ['--epochs', '2'])
        resumed = train_cli.main(common + ['--epochs', '3',
                                           '--bn_refresh', '2'])
        peak = torch.cuda.max_memory_allocated()
        for u in timers:
            u()
        results = test_cli.main(common[:8])
    finally:
        for u in undo + timers:
            u()
    launches = mk.LAUNCHES

    ckpts = sorted(p.name for p in (out / 'ckpt').iterdir())
    check(ckpts == [f'checkpoint_epoch_{e}.pth' for e in range(3)],
          f'checkpoints written: {ckpts}')
    check(first['start_step'] == 0 and resumed['start_step'] == 4,
          f'the resumed run started at step {resumed["start_step"]}')
    steps = first['steps'] + resumed['steps']
    check([r['it'] for r in steps] == list(range(1, 7)),
          f'steps {[r["it"] for r in steps]}')
    for r in steps:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'CLI step {r["it"]}: not finite: {bad}')
    check(step_launches == [4] * 6, f'merge-resolve launches per CLI '
                                    f'train step: {step_launches}')
    # parameters and BN stats loaded from the first run's last
    # checkpoint equal those it saved
    fresh = build_detector(cfg, device='cuda')
    fresh.net.load_state_dict(ck.load_checkpoint(
        out / 'ckpt' / 'checkpoint_epoch_1.pth')['model_state'])
    saved = first['detector'].net.state_dict()
    diff = [k for k, v in fresh.net.state_dict().items()
            if not torch.equal(v, saved[k])]
    check(not diff, f'reloaded tensors differ: {diff[:5]}')
    for r in steps:
        print(f'[cli] train step {r["it"]} (epoch {r["epoch"]}): data '
              f'{r["data_ms"]:.1f} ms, step {r["step_ms"]:.1f} ms, loss '
              f'{r["loss"]:.4f}, rcnn_loss_reg {r["rcnn_loss_reg"]:.4f}, '
              f'grad_norm {r["grad_norm"]:.3f}, lr {r["lr"]:.3e}')
    warm = [r for r in steps if r['it'] not in (1, 5)]
    data_ms = sum(r['data_ms'] for r in warm) / len(warm)
    step_ms = sum(r['step_ms'] for r in warm) / len(warm)
    mem_ms = sum(in_memory_ms) / len(in_memory_ms)
    print(f'[cli] train through the CLI, B={CLI_BATCH}: 3 checkpoints, '
          f'resumed at step {resumed["start_step"]}, reload bit-exact '
          f'({len(saved)} tensors), merge_resolve launches per step '
          f'{step_launches}; mean over the steps after each run\'s first: '
          f'data {data_ms:.1f} ms, step {step_ms:.1f} ms against the '
          f'in-memory train step {mem_ms:.1f} ms (phase [train]); '
          f'max_memory_allocated {peak / 2**30:.2f} GiB')
    n = data['collate n']
    ms = {k: 1e3 * data[k] / n for k in ('items', 'augment', 'gt_sampling',
                                          'collate', 'copy')}
    print(f'[cli] data per batch of {CLI_BATCH}, host ms (mean over {n} '
          f'batches of the train split, 2 of them the BN refresh\'s): '
          f'items {ms["items"] + ms["augment"] + ms["gt_sampling"]:.1f} = '
          f'gt sampling {ms["gt_sampling"]:.1f} + world flip / rotation / '
          f'scaling {ms["augment"]:.1f} + loading, FOV crop, range masks '
          f'and padding {ms["items"]:.1f}; '
          f'collation {ms["collate"]:.1f}; copy to the card '
          f'{ms["copy"]:.1f}')

    (path, res), = results.items()
    result_pkl = out / 'eval' / 'epoch_2' / 'result.pkl'
    check(path.endswith('checkpoint_epoch_2.pth') and result_pkl.exists(),
          f'test CLI evaluated {path}; result.pkl missing')
    check(res['frames'] == CLI_VAL, f'{res["frames"]} frames evaluated')
    keys = [f'Car_3d/{d}_R40' for d in ('easy', 'moderate', 'hard')]
    check(all(k in res['ap'] and np.isfinite(res['ap'][k]) for k in keys),
          f'AP keys missing: {sorted(res["ap"])}')
    check(predict_launches == [4] * math.ceil(CLI_VAL / CLI_BATCH),
          f'merge-resolve launches per CLI predict: {predict_launches}')
    print(f'[cli] test CLI on {Path(path).name}: {res["frames"]} val '
          f'frames, {res["sec_per_frame"]:.4f} s/frame (predicts and '
          f'prediction dicts), KITTI evaluation {res["eval_sec"]:.3f} s '
          f'(overlaps and matcher on the card); merge_resolve launches '
          f'per predict {predict_launches}; result.pkl written; '
          + ', '.join(f'{k} {res["ap"][k]:.2f}' for k in keys)
          + ' (random weights: only the keys are checked)')
    phase_eval(root, cfg)
    return launches, root


CVAE_DATA_PARTS = {'_load_points': 'load', 'occlude_aug': 'occlusion',
                   '__getitem__': 'rest', 'collate': 'collate'}


def cvae_batch_ms(parts, n_batches):
    """Host ms per batch of each timed part of the crop dataset."""
    return {k: 1e3 * parts.get(k, 0.0) / n_batches
            for k in CVAE_DATA_PARTS.values()}


def phase_cvae_full(tmp):
    """configs/cvae/exp_gen.yaml at full width on a synthetic gt database
    of KITTI's train-split size, fold 0 of 10: a warm-up and CVAE_STEPS
    timed train steps, one prediction pass over the val fold, and the
    projected wall time of the whole K-fold run.  Returns (cfg, the
    warm-up batch) for the GPU-against-CPU check."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import Cfg, cfg_from_yaml_file
    from glenet_tpu_torch.cvae import dataset as cds
    from glenet_tpu_torch.cvae import pipeline
    from glenet_tpu_torch.train import optim
    from glenet_tpu_torch.utils import synthetic
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/cvae/exp_gen.yaml'))
    root = tmp / 'cvae_crops'
    t0 = time.perf_counter()
    db = synthetic.write_crop_database(root, CVAE_CARS, CVAE_VANS, seed=SEED)
    n_pts = np.array([i['num_points_in_gt'] for v in db.values() for i in v])
    data_cfg = Cfg(dict(cfg.DATA_CONFIG, FOLD_IDX=0, NUM_FOLDS=CVAE_FOLDS))
    train_ds = cds.KittiGtDataset(data_cfg, training=True, root_path=root)
    val_ds = cds.KittiGtDataset(data_cfg, training=False, root_path=root)
    train_ds.rng = np.random.RandomState(SEED)
    val_ds.rng = np.random.RandomState(SEED + 1)
    print(f'[cvae] synthetic gt database: {len(db["Car"])} Car + '
          f'{len(db["Van"])} Van crops written in '
          f'{time.perf_counter() - t0:.1f} s, points per crop median '
          f'{int(np.median(n_pts))}, mean {n_pts.mean():.0f}, '
          f'{(n_pts > 1000).mean():.3f} of them above 1000; fold 0 of '
          f'{CVAE_FOLDS}: train {len(train_ds)} '
          f'({len(train_ds.dense_gt_infos)} dense donors), val '
          f'{len(val_ds)}')

    opt = cfg.OPTIMIZATION
    b, epochs = int(opt.BATCH_SIZE_PER_GPU), int(opt.NUM_EPOCHS)
    steps_per_epoch = len(train_ds) // b
    gen = pipeline.build_generator(cfg.MODEL, 'cuda', seed=SEED)
    tx, _ = optim.build_optimizer(opt, steps_per_epoch * epochs)
    opt_state = tx.init(list(gen.parameters()))
    step = pipeline.make_cvae_train_step(gen, cfg.MODEL, tx)
    generator = torch.Generator(device='cuda').manual_seed(SEED)
    anneal = min(1 / epochs, 1.0)         # the first epoch's KL weight
    train_ds.linear_anneal = anneal
    batches = train_ds.iter_batches(b, seed=SEED * 10000)
    parts = {}
    undo = [time_calls(cds.KittiGtDataset, a, parts, k)
            for a, k in CVAE_DATA_PARTS.items()]
    try:
        t0 = time.perf_counter()
        first = next(batches)
        step(opt_state, pipeline.to_device(first, 'cuda'), generator, anneal)
        torch.cuda.synchronize()
        print(f'[cvae] B={b} x {first["points"].shape[1]} points x '
              f'{first["points"].shape[2]} features, LATENT_DIM '
              f'{cfg.MODEL.LATENT_DIM}, '
              f'{sum(p.numel() for p in gen.parameters())} parameters; '
              f'adam_onecycle over {epochs} epochs x {steps_per_epoch} '
              f'steps; warm-up batch and step '
              f'{1e3 * (time.perf_counter() - t0):.1f} ms')
        params = {n: p.detach().clone() for n, p in gen.named_parameters()}
        stats = {n: t.clone() for n, t in gen.named_buffers()}
        parts.clear()
        recs = []
        for i in range(CVAE_STEPS):
            count = opt_state['count']
            t0 = time.perf_counter()
            batch = next(batches)
            t1 = time.perf_counter()
            tb = pipeline.to_device(batch, 'cuda')
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            metrics = step(opt_state, tb, generator, anneal)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            vals = {k: float(v) for k, v in metrics.items()}
            for k, v in vals.items():
                check(math.isfinite(v), f'CVAE step {i}: {k} = {v}')
            lr, b1 = opt_state['hyperparams']
            recs.append((1e3 * (t1 - t0), 1e3 * (t2 - t1), 1e3 * (t3 - t2)))
            print(f'[cvae] step {i}: data {recs[-1][0]:.1f} ms, copy '
                  f'{recs[-1][1]:.2f} ms, step {recs[-1][2]:.2f} ms; '
                  + ', '.join(f'{k} {v:.5f}' for k, v in sorted(vals.items()))
                  + f'; lr {lr:.6e}, b1 {b1:.6f} (update {count + 1}); '
                    f'max_memory_allocated '
                    f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
        ms = cvae_batch_ms(parts, CVAE_STEPS)
        n_occ = parts.get('occlusion n', 0)
        moved = [n for n, p in gen.named_parameters()
                 if not torch.equal(p.detach(), params[n])]
        check(len(moved) == len(params),
              f'CVAE parameters unchanged by {CVAE_STEPS} steps: '
              f'{sorted(set(params) - set(moved))}')
        bufs = dict(gen.named_buffers())
        same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
        check(not same, f'CVAE BN running stats unchanged: {same}')
        data_ms = sum(r[0] for r in recs) / len(recs)
        copy_ms = sum(r[1] for r in recs) / len(recs)
        step_ms = sum(r[2] for r in recs) / len(recs)
        print(f'[cvae] {CVAE_STEPS} steps: mean data {data_ms:.1f} ms per '
              f'batch of {b} (host: crop loads {ms["load"]:.1f}, occlusion '
              f'{ms["occlusion"]:.1f} over {n_occ / CVAE_STEPS:.1f} crops '
              f'(range views, convex hulls, calib and plane files), the '
              f'rest of the item {ms["rest"]:.1f}, collation '
              f'{ms["collate"]:.1f}), copy {copy_ms:.2f} ms, step '
              f'{step_ms:.2f} ms; all {len(params)} parameter tensors and '
              f'{len(stats)} BN stat tensors changed')

        parts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_pass = pipeline.predict_samples(gen, val_ds, cfg.MODEL,
                                            n_passes=1, batch_size=b,
                                            seed=SEED)
        pass_s = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    preds = np.stack([v['pred_box'] for v in per_pass[0].values()])
    check(preds.shape == (len(val_ds), 7) and np.isfinite(preds).all(),
          f'prediction pass: {preds.shape}, finite {np.isfinite(preds).all()}')
    n_val_batches = math.ceil(len(val_ds) / b)
    pms = cvae_batch_ms(parts, 1)
    print(f'[cvae] prediction pass over the val fold: {len(val_ds)} crops, '
          f'{n_val_batches} batches, {1e3 * pass_s:.1f} ms (host: crop loads '
          f'{pms["load"]:.1f} ms, items {pms["rest"]:.1f} ms, collation '
          f'{pms["collate"]:.1f} ms; the rest, copies and samples on the '
          f'card, {1e3 * pass_s - sum(pms.values()):.1f} ms)')
    per_step = data_ms + copy_ms + step_ms
    train_s = CVAE_FOLDS * epochs * steps_per_epoch * per_step / 1e3
    passes_s = CVAE_FOLDS * CVAE_PASSES * pass_s
    print(f'[cvae] projection, not a measurement: the whole {CVAE_FOLDS}-fold '
          f'run at these times would take {CVAE_FOLDS} folds x {epochs} '
          f'epochs x {steps_per_epoch} steps x {per_step:.1f} ms = '
          f'{train_s / 3600:.2f} h of training (data '
          f'{data_ms / per_step:.3f} of it) + '
          f'{CVAE_FOLDS} x {CVAE_PASSES} passes x {pass_s:.2f} s = '
          f'{passes_s / 3600:.2f} h of prediction, '
          f'{(train_s + passes_s) / 3600:.2f} h in all; cut in this run: '
          f'{CVAE_STEPS} of the steps, 1 of the passes, 1 of the folds')
    return cfg, first


def phase_cvae_cli(root, tmp):
    """The CVAE CLI end to end on the [cli] tree, GLENet-VR trained through
    the train CLI on the infos it writes, and the analysis of fold 0's
    passes.  Merge-resolve launches counted from 0 just before the
    detector training and read just after; returns them."""
    import math
    import pickle

    import numpy as np
    import torch

    from glenet_tpu_torch.cvae import analysis, pipeline
    from glenet_tpu_torch.ops import merge_kernel as mk
    from glenet_tpu_torch.tools import cvae_analysis, cvae_train
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.train import state as state_lib
    out = tmp / 'cvae_out'
    captured = []
    real_predict = pipeline.predict_samples

    def predict(*args, **kwargs):
        captured.append(real_predict(*args, **kwargs))
        return captured[-1]

    pipeline.predict_samples = predict
    t0 = time.perf_counter()
    try:
        unc = cvae_train.main([
            '--cfg_file', str(ROOT / 'configs/cvae/exp_gen.yaml'),
            '--data_path', str(root), '--folds', '2', '--passes',
            str(CVAE_PASSES), '--epochs', '2', '--output_dir', str(out),
            '--inject'])
    finally:
        pipeline.predict_samples = real_predict
    cli_s = time.perf_counter() - t0
    with open(out / 'un_v4.pkl', 'rb') as f:
        saved = pickle.load(f)
    with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
        cars = pickle.load(f)['Car']
    keys = [f"{i['image_idx']}_{i['gt_idx']}" for i in cars]
    check(set(saved) == set(unc) and set(keys) <= set(saved),
          f'un_v4.pkl misses {len(set(keys) - set(saved))} Car crops')
    vecs = np.stack([saved[k] for k in keys])
    check(vecs.shape == (len(keys), 7) and np.isfinite(vecs).all()
          and (vecs >= 0).all(), 'un_v4.pkl holds a negative or non-finite '
                                 'variance')
    with open(root / 'kitti_infos_train_wconf.pkl', 'rb') as f:
        wconf = pickle.load(f)
    n_other = 0
    for info in wconf:
        annos = info['annos']
        u, car = annos['uncertainty'], annos['name'] == 'Car'
        check(u.shape == (len(car), 7) and (u[car] >= 0).all()
              and (u[~car] == -1).all(),
              f'frame {info["image"]["image_idx"]}: bad uncertainty rows')
        n_other += int((~car).sum())
    check(n_other > 0, 'the _wconf infos hold no object of another class')
    print(f'[cvae] cvae_train --folds 2 --passes {CVAE_PASSES} --epochs 2 '
          f'--inject on the [cli] tree: {cli_s:.1f} s; un_v4.pkl covers all '
          f'{len(keys)} Car crops (variance per dim, mean '
          + ', '.join(f'{v:.4f}' for v in vecs.mean(0))
          + f'); kitti_infos_train_wconf.pkl: {len(wconf)} frames, '
            f'{n_other} rows of other classes at -1')

    step_launches, seen = [], []
    undo = count_launches(state_lib, 'make_train_step', step_launches)
    real_copy = train_cli.to_device

    def copy(batch, device):
        seen.append(batch)
        return real_copy(batch, device)

    train_cli.to_device = copy
    mk.LAUNCHES = 0
    try:
        run = train_cli.main([
            '--cfg_file', str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'),
            '--data_path', str(root), '--output_dir', str(tmp / 'vr_wconf'),
            '--batch_size', str(CLI_BATCH), '--epochs', '1',
            '--max_steps_per_epoch', '2', '--set',
            'DATA_CONFIG.INFO_PATH.train', 'kitti_infos_train_wconf.pkl',
            'DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST:0.DB_INFO_PATH',
            'kitti_dbinfos_train_wconf.pkl'])
    finally:
        undo()
        train_cli.to_device = real_copy
    launches = mk.LAUNCHES
    check(len(run['steps']) == 2 and step_launches == [4, 4],
          f'detector steps on the _wconf infos: {len(run["steps"])}, '
          f'merge-resolve launches {step_launches}')
    for r in run['steps']:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'detector step {r["it"]} on the _wconf infos: not '
                       f'finite: {bad}')
    known = {tuple(np.float32(v)) for v in saved.values()}
    rows = [tuple(u) for b in seen for u, m in zip(
        b['gt_uncertainty'].reshape(-1, 7), b['gt_mask'].reshape(-1)) if m]
    check(rows and all(r in known for r in rows),
          'a gt box of the detector batches carries a variance not in '
          'un_v4.pkl')
    print(f'[cvae] GLENet-VR through the train CLI on the _wconf infos '
          f'(--set DATA_CONFIG.INFO_PATH.train, ...AUG_CONFIG_LIST:0.'
          f'DB_INFO_PATH), B={CLI_BATCH}: ' + ', '.join(
              f'step {r["it"]} {r["step_ms"]:.1f} ms loss {r["loss"]:.4f} '
              f'rcnn_loss_reg {r["rcnn_loss_reg"]:.4f}' for r in run['steps'])
          + f'; {len(rows)} gt boxes, each with a variance from un_v4.pkl; '
            f'merge_resolve launches per step {step_launches}')

    fold0 = captured[0]
    check(len(fold0) == CVAE_PASSES, f'{len(fold0)} passes in fold 0')
    t0 = time.perf_counter()
    report = analysis.analyze(fold0)
    t1 = time.perf_counter()
    path = tmp / 'fold0_passes.pkl'
    with open(path, 'wb') as f:
        pickle.dump(fold0, f)
    via_cli = cvae_analysis.main([str(path)])
    check(np.isfinite(report['nll']) and 0 <= report['mean_iou'] <= 1
          and via_cli == report, f'analysis of fold 0: {report}, through '
                                 f'the CLI {via_cli}')
    print(f'[cvae] analysis of fold 0 ({CVAE_PASSES} passes, IoUs on the '
          f'card, {1e3 * (t1 - t0):.1f} ms): ' + json.dumps(report)
          + '; tools.cvae_analysis gives the same report')
    return launches


def phase_cvae_waymo(tmp):
    """One train step and one prediction pass of the Waymo configuration
    on a small synthetic database of 5-feature crops."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import Cfg, cfg_from_yaml_file
    from glenet_tpu_torch.cvae import dataset as cds
    from glenet_tpu_torch.cvae import pipeline
    from glenet_tpu_torch.train import optim
    from glenet_tpu_torch.utils import synthetic
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/cvae/waymo_exp_gen.yaml'))
    root = tmp / 'waymo_crops'
    synthetic.write_crop_database(root, WAYMO_CROPS, seed=SEED + 2,
                                  waymo=True)
    data_cfg = Cfg(dict(cfg.DATA_CONFIG, FOLD_IDX=0))
    train_ds = cds.WaymoGtDataset(data_cfg, training=True, root_path=root)
    val_ds = cds.WaymoGtDataset(data_cfg, training=False, root_path=root)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    gen = pipeline.build_generator(cfg.MODEL, 'cuda', seed=SEED)
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    opt_state = tx.init(list(gen.parameters()))
    batch = next(train_ds.iter_batches(b, seed=SEED))
    check(batch['points'].shape == (b, 512, 5), f'Waymo batch '
                                                f'{batch["points"].shape}')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = pipeline.make_cvae_train_step(gen, cfg.MODEL, tx)(
        opt_state, pipeline.to_device(batch, 'cuda'),
        torch.Generator(device='cuda').manual_seed(SEED), 1.0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vals = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in vals.values()), f'Waymo step {vals}')
    per_pass = pipeline.predict_samples(gen, val_ds, cfg.MODEL, n_passes=1,
                                        batch_size=b, seed=SEED)
    t2 = time.perf_counter()
    preds = np.stack([v['pred_box'] for v in per_pass[0].values()])
    check(preds.shape == (len(val_ds), 7) and np.isfinite(preds).all(),
          f'Waymo pass {preds.shape}')
    key = next(iter(per_pass[0]))
    check('#' in key, f'Waymo key {key}')
    print(f'[cvae] Waymo (waymo_exp_gen.yaml, 5 features, {WAYMO_CROPS} '
          f'crops, fold 0 of 5): train step B={b} {1e3 * (t1 - t0):.1f} ms '
          f'(first call), loss {vals["loss"]:.4f}, grad_norm '
          f'{vals["grad_norm"]:.3f}; a pass over {len(val_ds)} val crops '
          f'{1e3 * (t2 - t1):.1f} ms; keys like {key}')


def phase_cvae_gpu_vs_cpu(cfg, batch):
    """One full-width CVAE train step and one `sample` on the card and on
    the port's CPU path: same seeded weights, the same fixed eps, f32 with
    TF32 off."""
    import re

    import torch

    from glenet_tpu_torch.cvae import model as cm
    from glenet_tpu_torch.cvae import pipeline
    from glenet_tpu_torch.train import optim
    b, latent = batch['points'].shape[0], int(cfg.MODEL.LATENT_DIM)
    eps = torch.randn((b, latent), generator=torch.Generator().manual_seed(
        SEED + 21))
    saved = (cm.draw_eps, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    cm.draw_eps = lambda shape, generator, device: eps.to(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        for dev in ('cpu', 'cuda'):
            gen = pipeline.build_generator(cfg.MODEL, dev, seed=SEED + 5)
            with torch.no_grad():
                sampled = gen.sample(torch.from_numpy(batch['points']).to(dev))
            tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 1000)
            opt_state = tx.init(list(gen.parameters()))
            metrics = pipeline.make_cvae_train_step(gen, cfg.MODEL, tx)(
                opt_state, pipeline.to_device(batch, dev), None, 0.5)
            runs[dev] = ({k: float(v) for k, v in metrics.items()}, gen,
                         sampled.cpu(), tx)
    finally:
        (cm.draw_eps, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    (mc, gc, sc, tx), (mg, gg, sg, _) = runs['cpu'], runs['cuda']
    # f32 on both devices, sums in another order.  Loss terms rtol 1e-4.
    # Gradients: max |diff| <= 1e-3 max |grad| + 1e-6 per tensor, except
    # the biases a batch-moment BN follows (the PointNets' Dense biases,
    # fc1, fc2, SimPointNetFeat's last BN bias), whose exact gradient is 0
    # and whose computed one is rounding noise: both below 1e-4 of their
    # encoder's largest gradient.  BN stats rtol 1e-4 / atol 1e-5.
    # Parameters after the first Adam step, lr u(c g) with u(x) = x / (|x|
    # + 1e-8), g the gradient, c the clip factor: 1e-6 |p| + 1e-7 + lr
    # |u(c_cpu g_cpu) - u(c_gpu g_gpu)|, the gap of the two devices' own
    # first steps.  Sample: 1e-4 of its largest |value|.
    for k, v in mc.items():
        check(abs(mg[k] - v) <= 1e-4 * abs(v) + 1e-6,
              f'CVAE GPU and CPU differ in {k}: {mg[k]} vs {v}')
    grads_c = {n: p.grad for n, p in gc.named_parameters()}
    grads_g = {n: p.grad.cpu() for n, p in gg.named_parameters()}
    enc_max = {}
    for n, g in grads_c.items():
        e = n.split('.')[0]
        enc_max[e] = max(enc_max.get(e, 0.0), float(g.abs().max()))
    zero = re.compile(r'(PointNetFeat_0\.Dense_\d|fc1|fc2)\.bias$'
                      r'|SimPointNetFeat_0\.BatchNorm_2\.bias$')
    worst, n_zero = 0.0, 0
    for n, g in grads_c.items():
        if zero.search(n):
            n_zero += 1
            lim = 1e-4 * enc_max[n.split('.')[0]]
            check(float(g.abs().max()) <= lim
                  and float(grads_g[n].abs().max()) <= lim,
                  f'CVAE zero-gradient bias {n} above {lim:.3e}')
            continue
        err = float((g - grads_g[n]).abs().max())
        tol = 1e-3 * float(g.abs().max()) + 1e-6
        check(err <= tol, f'CVAE GPU and CPU gradients differ in {n}: '
                          f'{err:.3e} > {tol:.3e}')
        worst = max(worst, err / tol)
    check(n_zero == 12, f'{n_zero} zero-gradient biases')
    bufs_g = dict(gg.named_buffers())
    for n, t in gc.named_buffers():
        check(torch.allclose(t, bufs_g[n].cpu(), rtol=1e-4, atol=1e-5),
              f'CVAE GPU and CPU BN stats differ in {n}')
    lr = tx.hyperparams(0)[0]
    max_norm = float(cfg.OPTIMIZATION.GRAD_NORM_CLIP)

    def first_step(g, norm):
        g = min(1.0, max_norm / norm) * g.double()
        return g / (g.abs() + 1e-8)

    params_g = dict(gg.named_parameters())
    for n, p in gc.named_parameters():
        gap = (first_step(grads_c[n], mc['grad_norm'])
               - first_step(grads_g[n], mg['grad_norm'])).abs()
        bound = 1e-6 * p.detach().double().abs() + 1e-7 + lr * gap
        check(bool(((p.detach() - params_g[n].detach().cpu()).abs()
                    <= bound).all()),
              f'CVAE GPU and CPU parameters differ after the step in {n}')
    s_err = float((sc - sg).abs().max())
    check(s_err <= 1e-4 * float(sc.abs().max()),
          f'CVAE sample differs between GPU and CPU: {s_err:.3e}')
    print(f'[cvae] GPU against CPU, B={b} full width, TF32 off: loss terms '
          f'within rtol 1e-4 (' + ', '.join(
              f'{k} {v:.6f}' for k, v in sorted(mc.items()))
          + f'); gradients within 1e-3 of each tensor\'s largest (worst at '
            f'{worst:.3f} of it), the 12 zero-gradient biases below 1e-4 '
            f'of their encoder\'s largest; BN stats rtol 1e-4; parameters '
            f'after adam_onecycle within 1e-6 |p| + 1e-7 + lr |u(c_cpu '
            f'g_cpu) - u(c_gpu g_gpu)|; sample max_abs_err {s_err:.3e} '
            f'(limit 1e-4 of '
            f'{float(sc.abs().max()):.3f})')


def phase_cvae(tmp, cli_root):
    """[cvae]: (a) full width, (b) the CLI end to end, (c) Waymo, (d) the
    card against the CPU.  Returns the merge-resolve launches of (b)."""
    cfg, batch = phase_cvae_full(tmp)
    launches = phase_cvae_cli(cli_root, tmp)
    phase_cvae_waymo(tmp)
    phase_cvae_gpu_vs_cpu(cfg, batch)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if not (ROOT / 'glenet_tpu_torch').is_dir():
        print('chip_smoke: run from a checkout of the repository',
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    try:
        card = phase_setup(['merge_resolve'])
        cfg, det, batches, captured = prepare_full_width()
        launches = phase_full_width(det, batches)
        launches_train, captured_train, train_ms = phase_train(cfg, det)
        with tempfile.TemporaryDirectory(prefix='glenet_smoke_') as tmp:
            launches_cli, cli_root = phase_cli(train_ms, Path(tmp))
            launches_cvae = phase_cvae(Path(tmp), cli_root)
        merge = phase_merge_check(captured, captured_train)
        phase_gpu_vs_cpu()
        phase_gpu_vs_cpu_train()
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {type(e).__name__}: {e}',
              file=sys.stderr)
        return 1
    train = merge['train']
    kernels = [{
        'name': 'merge_resolve', 'route': 'cuda',
        'source': 'glenet_tpu_torch/csrc/merge_resolve.cu',
        'replaces': 'glenet_tpu/ops/merge_kernel.py:95',
        'launches': launches + launches_train + launches_cli + launches_cvae,
        'max_abs_err': merge['max_abs_err'],
        'ms': merge['ms'], 'plain_ms': merge['plain_ms'],
        'bound_ms': merge['bound_ms'], 'bound_by': merge['bound_by'],
        'library_ms': merge['library_ms'], 'device_ms': merge['device_ms'],
        'library_device_ms': merge['library_device_ms'],
        'cold_ms': merge['cold_ms'], 'host_ms': merge['host_ms'],
        'launches_predict': launches, 'launches_train': launches_train,
        'launches_cli': launches_cli, 'launches_cvae': launches_cvae,
        'train_ms': train['ms'], 'train_device_ms': train['device_ms'],
        'train_plain_ms': train['plain_ms'],
        'train_bound_ms': train['bound_ms'],
        'train_bound_by': train['bound_by'],
        'train_library_ms': train['library_ms'],
        'train_library_device_ms': train['library_device_ms']}]
    print(f'[done] all phases passed in {time.perf_counter() - t_start:.1f} '
          f's; kernel times are per predict (sum of its 4 calls), train_* '
          f'per train step (sum of its 4 calls); launches are counted over '
          f'the {N_REQUESTS} predicts, the {TRAIN_STEPS} train steps, the '
          f'CLI phase (6 train steps, 2 BN-refresh forwards, 1 predict) '
          f'and the CVAE phase\'s detector training (2 train steps)')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
