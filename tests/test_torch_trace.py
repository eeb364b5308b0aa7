"""The port's spans and counters (glenet_tpu_torch/utils/trace.py): off
without a profiler, nested `glenet::*` ranges under one top span a call
with one, and counters that match counts made by hand."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from glenet_tpu_torch.utils import trace

PREDICT_LAYERS = {'voxelize', 'vfe', 'backbone_3d', 'backbone_2d',
                  'dense_head', 'decode', 'nms'}
TRAIN_LAYERS = {'voxelize', 'vfe', 'backbone_3d', 'backbone_2d',
                'dense_head', 'targets', 'loss', 'backward', 'optim'}
RANGE = 9.6


@pytest.fixture(autouse=True)
def fresh_counters():
    trace.reset()
    yield
    trace.reset()


def traced(record_shapes=False):
    return profile(activities=[ProfilerActivity.CPU],
                   record_shapes=record_shapes)


def waymo_cfg(yaml, max_voxels):
    """A Waymo yaml of configs/ at its published widths over +-9.6 m."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    cfg = cfg_from_yaml_file(f'configs/waymo_models/{yaml}')
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [-RANGE, -RANGE, -2, RANGE, RANGE,
                                         4]
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'transform_points_to_voxels':
            proc.MAX_NUMBER_OF_VOXELS = {'train': max_voxels,
                                         'test': max_voxels}
    return cfg


def scene(batch, n_points, seed):
    """Uniform 5-feature points over the range and two Vehicles a scene."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand(batch, n_points, 5, generator=g)
    pts[..., :2] = pts[..., :2] * 2 * RANGE - RANGE
    pts[..., 2] = pts[..., 2] * 6 - 2
    gt = torch.zeros(batch, 4, 8)
    gt[:, 0] = torch.tensor([2.0, 3.0, 0.5, 4.5, 2.0, 1.6, 0.3, 1])
    gt[:, 1] = torch.tensor([-4.0, -2.0, 0.5, 4.2, 1.9, 1.5, -1.0, 1])
    return {'points': pts,
            'points_mask': torch.ones(batch, n_points, dtype=torch.bool),
            'gt_boxes': gt, 'gt_mask': torch.arange(4).expand(batch, 4) < 2,
            'gt_uncertainty': torch.full((batch, 4, 7), 0.1)}


def glenet_spans(prof):
    return [e for e in prof.events() if e.name.startswith(trace.PREFIX)]


def calls_of(spans, top):
    """[(top span, {layer spans inside it})] in call order; every layer
    span lies inside exactly one top span."""
    tops = sorted((e for e in spans if e.name == trace.PREFIX + top),
                  key=lambda e: e.time_range.start)
    out = [(t, set()) for t in tops]
    for e in spans:
        if e.name == trace.PREFIX + top:
            continue
        inside = [names for t, names in out
                  if t.time_range.start <= e.time_range.start
                  and e.time_range.end <= t.time_range.end]
        assert len(inside) == 1, e.name
        inside[0].add(e.name[len(trace.PREFIX):])
    return out


def test_off_without_a_profiler(monkeypatch):
    def no_range(*args):
        raise AssertionError('a range was recorded with tracing off')

    monkeypatch.setattr(trace, '_range', no_range)
    assert not trace.enabled()
    assert trace.span('vfe') is trace.OFF
    assert trace.call_span('predict') is trace.OFF
    with trace.span('vfe'):
        pass
    trace.count('host_waits', 3)
    trace.count('voxels_kept', torch.ones(4, dtype=torch.bool))
    assert trace.device_slots(('a', 'b'), 'cpu') is None
    assert trace.counters() == {'calls': 0}


def test_counters_sum_host_and_device_counts():
    with traced():
        assert trace.enabled()
        trace.count('host_waits')
        trace.count('host_waits', 2)
        trace.count('kept', torch.tensor([True, False, True]))
        trace.count('kept', torch.tensor(4))
        slots = trace.device_slots(('wide', 'glob'), 'cpu')
        assert slots is trace.device_slots(('wide', 'glob'), 'cpu')
        slots += torch.tensor([5, 7], dtype=torch.int32)
    assert trace.counters() == {'host_waits': 3, 'kept': 6, 'wide': 5,
                                'glob': 7, 'calls': 0}
    trace.reset()
    assert trace.counters() == {'calls': 0}


def test_predict_spans_nest_under_one_top_span_a_call():
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(waymo_cfg('centerpoint.yaml', 200), device='cpu')
    batch = scene(1, 3000, seed=1)
    with traced(record_shapes=True) as prof:
        for _ in range(2):
            det.predict({k: batch[k] for k in ('points', 'points_mask')})
    calls = calls_of(glenet_spans(prof), 'predict')
    assert [t.concrete_inputs for t, _ in calls] == [[0], [1]]
    assert [names for _, names in calls] == [PREDICT_LAYERS] * 2
    assert trace.counters()['calls'] == 2


def test_train_step_spans_nest_under_one_top_span_a_call():
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train.optim import build_optimizer
    from glenet_tpu_torch.train.state import (create_train_state,
                                              make_train_step)
    cfg = waymo_cfg('GLENet_S.yaml', 300)
    det = build_detector(cfg, device='cpu')
    tx, _ = build_optimizer(cfg.OPTIMIZATION, 100)
    state = create_train_state(det, tx)
    step = make_train_step(det, tx)
    batch = scene(2, 2000, seed=2)
    with traced(record_shapes=True) as prof:
        for _ in range(2):
            state, metrics = step(state, batch)
    assert math.isfinite(float(metrics['loss']))
    calls = calls_of(glenet_spans(prof), 'train_step')
    assert [t.concrete_inputs for t, _ in calls] == [[0], [1]]
    assert [names for _, names in calls] == [TRAIN_LAYERS] * 2


def occupied_voxels(points, voxel_size, pc_range):
    """Distinct in-range voxels of the points, counted in numpy."""
    p = points[:, :3].numpy().astype(np.float64)
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:])
    grid = np.round((hi - lo) / voxel_size).astype(np.int64)
    c = np.floor((p - lo) / voxel_size).astype(np.int64)
    ok = np.all((c >= 0) & (c < grid), axis=1)
    return {tuple(v) for v in c[ok]}, grid


def active_sites(voxels, grid, stride=2, pad=1, k=3):
    """Output sites of a strided conv (output o active iff some voxel
    i = o * stride - pad + tap), counted in numpy."""
    out_grid = (np.asarray(grid) + 2 * pad - k) // stride + 1
    sites = set()
    for v in voxels:
        per_dim = []
        for i, n in zip(v, out_grid):
            per_dim.append([(i + pad - t) // stride for t in range(k)
                            if (i + pad - t) % stride == 0
                            and 0 <= (i + pad - t) // stride < n])
        sites.update((x, y, z) for x in per_dim[0] for y in per_dim[1]
                     for z in per_dim[2])
    return sites, tuple(int(n) for n in out_grid)


def test_counters_match_hand_counts_where_budgets_drop():
    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.ops import voxelize as vox_ops
    pc_range = (-RANGE, -RANGE, -2.0, RANGE, RANGE, 4.0)
    size = np.array([0.4, 0.4, 0.5])
    points = scene(1, 1500, seed=3)['points'][0]
    voxels, grid = occupied_voxels(points, size, pc_range)
    budget = 400
    assert len(voxels) > budget
    with traced():
        out = vox_ops.voxelize(points, torch.ones(1500, dtype=torch.bool),
                               tuple(size), pc_range, tuple(grid), budget, 5)
        kept_ids = out['voxel_coords'][out['voxel_mask']]    # (z, y, x)
        nx, ny, nz = grid
        ids = (kept_ids[:, 0] * ny * nx + kept_ids[:, 1] * nx
               + kept_ids[:, 2]).to(torch.int32).sort().values
        cap = 500
        sparse.strided_output_sites(ids, torch.ones_like(ids, dtype=bool),
                                    tuple(grid), 3, 2, 1, cap)
    counts = trace.counters()
    assert counts['voxels_offered'] == len(voxels)
    assert counts['voxels_kept'] == budget
    kept = {(int(x), int(y), int(z)) for z, y, x in kept_ids.tolist()}
    sites, out_grid = active_sites(kept, grid)
    level = 'x'.join(map(str, out_grid))
    assert counts[f'sites_active.{level}'] == len(sites) > cap
    assert counts[f'sites_kept.{level}'] == cap
    # two pageable copies in voxelize, one in strided_output_sites
    assert counts['host_waits'] == 3


def test_lazy_nms_waits_once_a_block():
    """600 candidates apart from each other: 3 blocks of 256.  The host
    waits for the corners' template, for the live count, then per block
    for the keep rounds (one round and the read that ends them) and for
    the kept count."""
    from glenet_tpu_torch.ops import nms
    n = 600
    xy = torch.stack(torch.meshgrid(torch.arange(30.0), torch.arange(20.0),
                                    indexing='ij'), -1).reshape(-1, 2) * 5
    boxes = torch.cat([xy, torch.zeros(n, 1), torch.ones(n, 3),
                       torch.zeros(n, 1)], 1)
    live = torch.ones(n, dtype=torch.bool)
    with traced():
        keep = nms._greedy_keep_lazy(boxes, live, 0.5, post_max=1000)
    assert bool(keep.all())
    blocks = math.ceil(n / nms._LAZY_BLK)
    assert trace.counters()['host_waits'] == 2 + 3 * blocks


def test_data_parallel_step_spans_its_gradient_all_reduce(tmp_path):
    """On 2 gloo ranks the step's gradient sum is the span
    glenet::grad_allreduce, between the backward and the optimizer."""
    import torch_dist as td
    batch = {k: v.numpy() for k, v in scene(2, 2000, seed=4).items()}
    ranks = td.launch('dp_spans', 2, {'cfg': waymo_cfg('GLENet_S.yaml', 300),
                                      'batch': batch}, tmp_path)
    for spans in ranks:
        by_name = {name[len(trace.PREFIX):]: (a, b) for name, a, b in spans}
        assert set(by_name) == TRAIN_LAYERS | {'train_step',
                                               'grad_allreduce'}
        top = by_name['train_step']
        a, b = by_name['grad_allreduce']
        assert top[0] <= a and b <= top[1]
        assert by_name['backward'][1] <= a and b <= by_name['optim'][0]
