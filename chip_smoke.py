#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (glenet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. set-up: the card's name and power limit, torch / CUDA versions, and the
     build of every CUDA kernel of the port (one nvcc per source, all
     started together);
  2. kernel check: every kernel equals its plain PyTorch version on
     adversarial cases and on the (ids, queries) pairs captured from one
     full-width predict (a warm-up); kernel, plain and library times;
  3. GPU against CPU: the toy two-stage GLENet-VR topology, same seeded
     weights and points, f32 on both sides with TF32 off;
  4. full width: configs/kitti_models/GLENet_VR.yaml predict on 3 requests
     of B = 2 synthetic KITTI-like scenes of 32768 points (random seeded
     weights, default dtypes), launches counted from 0 over those requests;
  5. one `{"kernels": [...]}` line; last line `{"ok": true, "device": ...}`.

Needs one CUDA device and the repository checkout around this file.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM CUDA-core rate, no tensor cores
N_REQUESTS, BATCH, N_POINTS = 3, 2, 32768

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
        },
        'ROI_HEAD': {
            'NAME': 'VoxelRCNNKLLabelIoUHead', 'CLASS_AGNOSTIC': True,
            'SHARED_FC': [32, 32], 'CLS_FC': [32], 'REG_FC': [32],
            'DP_RATIO': 0.3,
            'NMS_CONFIG': {'TEST': {
                'NMS_TYPE': 'nms_gpu', 'NMS_PRE_MAXSIZE': 256,
                'NMS_POST_MAXSIZE': 32, 'NMS_THRESH': 0.7,
                'SCORE_THRESH': 0.0}},
            'ROI_GRID_POOL': {
                'FEATURES_SOURCE': ['x_conv2', 'x_conv3', 'x_conv4'],
                'GRID_SIZE': 4,
                'POOL_LAYERS': {'x_conv2': {'MLPS': [[16, 16]]},
                                'x_conv3': {'MLPS': [[16, 16]]},
                                'x_conv4': {'MLPS': [[16, 16]]}}},
        },
        'POST_PROCESSING': {
            'SCORE_THRESH': 0.1,
            'NMS_CONFIG': {'MULTI_CLASSES_NMS': False,
                           'NMS_TYPE': 'new_nms_gpu', 'NMS_THRESH': 0.1,
                           'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 32}},
    },
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, iters=20):
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(3):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


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

    cases = {}
    ids = srt(torch.randint(0, 5000, (2, 700), generator=g))
    cases['random'] = (ids, srt(torch.randint(-10, 5100, (2, 9, 900),
                                              generator=g)))
    cases['all_sentinel'] = (torch.full((2, 512), 1000, dtype=torch.int32),
                             srt(torch.randint(0, 1001, (2, 3, 600),
                                               generator=g)))
    ids = srt(torch.randint(10_000, 20_000, (1, 4000), generator=g))
    cases['below_table'] = (ids, srt(torch.randint(0, 12_000, (1, 9, 3000),
                                                   generator=g)))
    ids = srt(torch.randint(0, 90_000_000, (2, 5000), generator=g))
    cases['negative_raw'] = (ids, srt(torch.randint(
        -2_000_000, 90_000_100, (2, 9, 5000), generator=g)))
    v = (1 << 20) - 1
    ids = srt(torch.randint(0, 1 << 26, (1, v), generator=g))
    cases['v_near_2^20'] = (ids, srt(torch.randint(-5, (1 << 26) + 5,
                                                   (1, 9, 200_000),
                                                   generator=g)))
    return cases


def merge_bound(ids, queries):
    """Least time for the merge-resolve function on these inputs: each input
    read once and the 4 int32 outputs written once over the memory rate,
    against ~log2(V)+3 integer compares per query over the CUDA-core rate."""
    n_q = queries.numel()
    nbytes = ids.numel() * 4 + n_q * 4 + 4 * n_q * 4
    ops = n_q * (math.ceil(math.log2(ids.shape[1] + 1)) + 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def phase_merge_check(captured):
    """Kernel == plain on adversarial and captured cases; times."""
    import torch

    from glenet_tpu_torch.ops import merge_kernel as mk
    max_err = 0
    for name, (ids, q) in adversarial_merge_cases().items():
        ids, q = ids.cuda(), q.cuda()
        got = mk.resolve_sorted_queries(ids, q)
        ref = mk.resolve_sorted_queries_plain(ids, q)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(got, ref))
        print(f'[kernel] merge_resolve {name}: ids {tuple(ids.shape)} '
              f'queries {tuple(q.shape)} max_abs_err {err}')
        check(err == 0, f'merge_resolve differs from its plain version on '
                        f'{name}')
        max_err = max(max_err, err)
    check(len(captured) == 4, f'expected 4 table builds per predict, saw '
                              f'{len(captured)}')
    tot = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 'bound_ms': 0.0}
    bound_by = set()
    for i, (ids, q) in enumerate(captured):
        got = mk.resolve_sorted_queries(ids, q)
        ref = mk.resolve_sorted_queries_plain(ids, q)
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(got, ref))
        check(err == 0, f'merge_resolve differs on captured call {i}')
        max_err = max(max_err, err)
        q2 = q.reshape(q.shape[0], -1)
        ms = cuda_time_ms(lambda: mk.resolve_sorted_queries(ids, q))
        plain = cuda_time_ms(lambda: mk.resolve_sorted_queries_plain(ids, q))
        lib = cuda_time_ms(lambda: torch.searchsorted(ids, q2))
        bound, by = merge_bound(ids, q)
        bound_by.add(by)
        print(f'[kernel] merge_resolve call {i}: ids {tuple(ids.shape)} '
              f'queries {tuple(q.shape)} kernel {ms:.4f} ms, plain '
              f'{plain:.4f} ms, torch.searchsorted (pos only) {lib:.4f} ms, '
              f'bound {bound:.4f} ms ({by})')
        for k, t in zip(('ms', 'plain_ms', 'library_ms', 'bound_ms'),
                        (ms, plain, lib, bound)):
            tot[k] += t
    return {'max_abs_err': max_err, 'bound_by': '/'.join(sorted(bound_by)),
            **tot}


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


def prepare_full_width():
    """GLENet_VR.yaml at full width on the card: seeded detector, the
    requests' scenes, and one warm-up predict that captures the inputs of
    the four merge-resolve calls."""
    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.ops import merge_kernel as mk
    from glenet_tpu_torch.utils.synthetic import make_scene, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    det = seeded_detector(cfg, 'cuda', SEED)
    rng = np.random.RandomState(SEED)
    batches = []
    for _ in range(N_REQUESTS + 1):
        pts = torch.from_numpy(np.stack([make_scene(rng, N_POINTS)
                                         for _ in range(BATCH)])).cuda()
        batches.append({'points': pts,
                        'points_mask': torch.ones(pts.shape[:2],
                                                  dtype=torch.bool,
                                                  device='cuda')})
    captured = []
    real = mk.resolve_sorted_queries

    def recorder(ids, queries):
        captured.append((ids.clone(), queries.clone()))
        return real(ids, queries)

    mk.resolve_sorted_queries = recorder
    try:
        t0 = time.perf_counter()
        det.predict(batches[0])
        torch.cuda.synchronize()
        print(f'[kernel] warm-up full-width predict '
              f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    finally:
        mk.resolve_sorted_queries = real
    return det, batches[1:], captured


def phase_full_width(det, batches):
    """The main path: N_REQUESTS predicts, merge-resolve launches counted
    from 0 just before and read just after."""
    import torch

    from glenet_tpu_torch.ops import merge_kernel as mk
    from glenet_tpu_torch.ops import sparse
    caps = sparse.level_caps(det.max_voxels_test)
    sites = {}

    def record_sites(_mod, _inp, out):
        ms = out['multi_scale']
        sites.update({
            'x_conv1': ms['x_conv1']['mask'].sum(1),
            'x_conv2': ms['x_conv2']['mask'].sum(1),
            'x_conv3': ms['x_conv3']['mask'].sum(1),
            'x_conv4': ms['x_conv4']['occ'].flatten(1).sum(1)})

    def record_proposals(_mod, _inp, out):
        sites['proposals'] = out['proposals']['roi_valid'].sum(1)

    hooks = [det.net.backbone_3d.register_forward_hook(record_sites),
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
        lvl = ', '.join(
            f'{k} {st[k].tolist()}' + (f'/{caps[i]}' if i < 3 else '')
            for i, k in enumerate(('x_conv1', 'x_conv2', 'x_conv3',
                                   'x_conv4')))
        print(f'[full] request {r}: {times[r]:.1f} ms; active sites {lvl}; '
              f'valid proposals {st["proposals"].tolist()}; valid final '
              f'boxes {pred["final_valid"].sum(1).tolist()}; '
              f'merge_resolve launches {n_launch}; max_memory_allocated '
              f'{mem / 2**30:.2f} GiB')
    print(f'[full] GLENet-VR predict B={BATCH} x {N_POINTS} points: '
          f'mean {sum(times) / len(times):.1f} ms over {len(times)} requests')
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
        det, batches, captured = prepare_full_width()
        merge = phase_merge_check(captured)
        phase_gpu_vs_cpu()
        launches = phase_full_width(det, batches)
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {type(e).__name__}: {e}',
              file=sys.stderr)
        return 1
    kernels = [{
        'name': 'merge_resolve', 'route': 'cuda',
        'source': 'glenet_tpu_torch/csrc/merge_resolve.cu',
        'replaces': 'glenet_tpu/ops/merge_kernel.py:95',
        'launches': launches, 'max_abs_err': merge['max_abs_err'],
        'ms': merge['ms'], 'plain_ms': merge['plain_ms'],
        'bound_ms': merge['bound_ms'], 'bound_by': merge['bound_by'],
        'library_ms': merge['library_ms']}]
    print(f'[done] all phases passed in {time.perf_counter() - t_start:.1f} '
          f's; kernel times are per predict (sum of its 4 calls)')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
