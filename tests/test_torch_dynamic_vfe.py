"""Parity of the port's scatter path (glenet_tpu_torch/ops/scatter.py,
ops/voxelize.py::voxelize_dynamic, models/vfe.py DynamicMeanVFE and
DynamicPillarVFE) and of VoxelResBackBone8x with glenet_tpu on the CPU,
inputs drawn from numpy seeds, f32:

  - segment_sum / segment_mean / segment_max with -1 ids and empty
    segments: values rtol 1e-6 / atol 1e-6 (segment_max exactly), and
    their gradients against jax.vjp, on data whose maxima tie (ReLU zeros
    and repeated values: the cotangent splits evenly among tied rows);
  - voxelize_dynamic: voxel coords, mask and every point's slot exactly,
    with the budget below the occupied voxels, masked-off points and
    points out of range;
  - DynamicMeanVFE on the batch flattened into the point and slot axes:
    rtol 1e-6 / atol 1e-6;
  - DynamicPillarVFE (two layers, the second concatenating the pillar max
    back): eval and train outputs, BN running stats, the gradients of
    every parameter (rtol 1e-4 / atol 1e-5; gradients per tensor max
    |diff| <= 2e-4 max |grad| + 1e-6), both name spellings building;
  - VoxelResBackBone8x at a toy grid (48 x 48 x 40, 1200 voxels), f32
    pinned: every level's ids, masks and occupancy exactly, features and
    the BEV map rtol 1e-4 / atol 1e-5 in eval mode, in train mode rtol
    1e-4 / atol 1e-5 x the tensor's largest |value| (each package sums a
    level's BN moments over its sites in its own order, which moves an
    output near the channel's mean by ~1e-5 of the level's scale), and the
    BN running stats after the train forward.  In train mode a ReLU input of
    the dense levels (BN moments over few sites) can lie within f32
    rounding of 0 and land on the other side of it in the other package:
    the port takes glenet_tpu's side there, each such element within 1e-5
    of its BN's largest |output| on both sides (torch_parity.
    align_relu_kinks; any larger flip fails), at most 8 of them."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

from glenet_tpu.ops import scatter as jsc  # noqa: E402
from glenet_tpu.ops import voxelize as jvox  # noqa: E402

from glenet_tpu_torch.ops import scatter as tsc  # noqa: E402
from glenet_tpu_torch.ops import voxelize as tvox  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
VS = (0.4, 0.4, 0.15)
PR = (-9.6, -9.6, -2.0, 9.6, 9.6, 4.0)
PILLAR_VS = (0.32, 0.32, 6.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _segments(seed=0, n=600, c=5, num=80):
    """Ids in [-1, num) with segments 70..79 empty, data with ReLU zeros
    and repeated values, so segment maxima tie."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(-1, 70, n).astype(np.int32)
    data = np.maximum(rng.randn(n, c), 0).astype(np.float32)
    data[rng.uniform(0, 1, (n, c)) < 0.2] = 0.75
    return data, ids, num


@pytest.mark.parametrize('op', ['segment_sum', 'segment_mean',
                                'segment_max'])
def test_segment_op_and_gradient(op):
    data, ids, num = _segments()
    w = np.random.RandomState(1).randn(num, data.shape[1]).astype(np.float32)
    ref, vjp = jax.vjp(lambda d: getattr(jsc, op)(d, jnp.asarray(ids), num),
                       jnp.asarray(data))
    d = _t(data).requires_grad_()
    got = getattr(tsc, op)(d, _t(ids), num)
    (got * _t(w)).sum().backward()
    ref = np.asarray(ref)
    assert not ref[70:].any()
    if op == 'segment_max':
        np.testing.assert_array_equal(got.detach().numpy(), ref)
        # ties: some segment max is shared by two or more rows
        valid = ids >= 0
        hits = (data[valid] == ref[ids[valid]]).sum(0)
        assert (hits > 70).any()
    else:
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6,
                                   atol=1e-6)
    g_ref = np.asarray(vjp(jnp.asarray(w))[0])
    assert not g_ref[ids < 0].any()
    np.testing.assert_allclose(d.grad.numpy(), g_ref, rtol=1e-6, atol=1e-7)


def _cloud(seed, n=3000, features=5):
    """Points over the toy range and beyond it, a tenth masked off."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((n, features), np.float32)
    pts[:, :2] = rng.uniform(-10.5, 10.5, (n, 2))
    pts[:, 2] = rng.uniform(-2.2, 4.2, n)
    pts[:, 3:] = rng.uniform(0, 1, (n, features - 3))
    # clusters, so voxels hold several points
    pts[:600, :3] = pts[:60, :3].repeat(10, 0) + rng.uniform(
        -0.2, 0.2, (600, 3))
    return pts, rng.uniform(0, 1, n) > 0.1


@pytest.mark.parametrize('budget', [600, 5000])
def test_voxelize_dynamic(budget):
    pts, mask = _cloud(2)
    grid = tvox.compute_grid_size(PR, VS)
    ref = jvox.voxelize_dynamic(jnp.asarray(pts), jnp.asarray(mask), VS, PR,
                                grid, max_voxels=budget)
    got = tvox.voxelize_dynamic(_t(pts), _t(mask), VS, PR, grid, budget)
    for k in ('voxel_coords', 'voxel_mask', 'point_voxel_idx'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    n_vox = int(got['voxel_mask'].sum())
    pvi = got['point_voxel_idx'].numpy()
    assert (n_vox == budget) == (budget == 600)
    assert (pvi == -1).sum() > 300 and (pvi >= 0).sum() > 500


def _flat_batch(seed, vs, budget, b=2):
    """Two clouds voxelized dynamically by glenet_tpu, flattened as its
    DetectorNet does: points (B * N, C), slots offset by b * budget."""
    clouds = [_cloud(seed + i) for i in range(b)]
    grid = tvox.compute_grid_size(PR, vs)
    vox = [jvox.voxelize_dynamic(jnp.asarray(p), jnp.asarray(m), vs, PR,
                                 grid, max_voxels=budget) for p, m in clouds]
    idx = np.concatenate([np.where(np.asarray(v['point_voxel_idx']) >= 0,
                                   np.asarray(v['point_voxel_idx'])
                                   + i * budget, -1)
                          for i, v in enumerate(vox)]).astype(np.int32)
    pts = np.concatenate([p for p, _ in clouds])
    coords = np.concatenate([np.asarray(v['voxel_coords']) for v in vox])
    return pts, idx, coords, b * budget


def test_dynamic_mean_vfe():
    from glenet_tpu.models.vfe import DynamicMeanVFE as JVFE

    from glenet_tpu_torch.models.vfe import DynamicMeanVFE
    pts, idx, _, num = _flat_batch(3, VS, 800)
    ref = JVFE().apply({}, jnp.asarray(pts), jnp.asarray(idx), num)
    got = DynamicMeanVFE()(_t(pts), _t(idx), num)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_dynamic_pillar_vfe():
    from glenet_tpu.models.vfe import DynamicPillarVFE as JVFE
    from test_torch_three_class_modules import _compare_module

    from glenet_tpu_torch.models.vfe import DynamicPillarVFE
    pts, idx, coords, num = _flat_batch(4, PILLAR_VS, 700)
    jmod = JVFE(num_filters=(16, 16), voxel_size=PILLAR_VS,
                point_cloud_range=PR)
    tmod = DynamicPillarVFE(5, (16, 16), PILLAR_VS, PR)
    w = np.random.RandomState(9).randn(num, 16).astype(np.float32)
    _compare_module(jmod, tmod, (jnp.asarray(pts), jnp.asarray(idx),
                                 jnp.asarray(coords), num),
                    lambda: (_t(pts), _t(idx), _t(coords), num), {'out': w})


@pytest.mark.parametrize('name', ['DynPillarVFE', 'DynamicPillarVFE',
                                  'DynMeanVFE', 'DynamicMeanVFE'])
def test_dynamic_vfe_names_build(name):
    """Both spellings build, as glenet_tpu accepts them."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models import vfe
    from glenet_tpu_torch.models.detectors import build_detector
    pillar = 'Pillar' in name
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/waymo_models' / (
        'centerpoint_dyn_pillar_1x.yaml' if pillar
        else 'voxel_rcnn_with_centerhead_dyn_voxel.yaml')))
    cfg.MODEL.VFE.NAME = name
    det = build_detector(cfg, device='cpu')
    assert isinstance(det.net.vfe, vfe.DynamicPillarVFE if pillar
                      else vfe.DynamicMeanVFE)


def _res_backbone_case():
    vs = (0.4, 0.4, 0.15)
    pr = (-9.6, -9.6, -2.0, 9.6, 9.6, 4.0)
    grid = tvox.compute_grid_size(pr, vs)
    clouds = [_cloud(10 + i, n=2500) for i in range(2)]
    vox = [jvox.voxelize(jnp.asarray(p), jnp.asarray(m), vs, pr, grid,
                         max_voxels=1200, max_points_per_voxel=5)
           for p, m in clouds]
    vox = {k: np.stack([np.asarray(v[k]) for v in vox]) for k in vox[0]}
    n = np.maximum(vox['voxel_num_points'], 1)[..., None]
    feats = (vox['voxels'].sum(2) / n).astype(np.float32)
    return grid, feats, vox['voxel_coords'], vox['voxel_mask']


@pytest.mark.parametrize('train', [False, True])
def test_voxel_res_backbone(train):
    from glenet_tpu.models.layers import MaskedBatchNorm as JaxBN
    from glenet_tpu.models.spconv_backbone import (
        build_backbone_3d as jbuild)

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.models.spconv_backbone import build_backbone_3d
    from glenet_tpu_torch.utils.jax_weights import (jax_tree_to_port,
                                                    load_jax_variables)
    grid, feats, coords, mask = _res_backbone_case()
    assert grid == (48, 48, 40) and mask.sum() > 1500
    cfg = Cfg({'NAME': 'VoxelResBackBone8x'})
    jmod = jbuild(cfg, grid_size=grid, max_voxels=1200, site_lists=False)
    tmod = build_backbone_3d(cfg, grid, 5)
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask))
    with tp.pinned_f32():
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                                  *args, train=True))
        v = tp.random_variables(shapes, seed=7)
        load_jax_variables(tmod, v)
        def run(vv, a):
            out, st = jmod.apply(
                vv, *a, train=train,
                mutable=['batch_stats', 'intermediates'],
                capture_intermediates=lambda mdl, _: isinstance(mdl, JaxBN))
            ms = {lvl: {f: x[f] for f in ('features', 'ids', 'mask', 'occ')
                        if f in x} for lvl, x in out['multi_scale'].items()}
            return {'multi_scale': ms,
                    'bev_features': out['bev_features']}, st

        ref, state = jax.jit(run)(v, args)
        seen, hooks = ({'flipped': 0}, []) if not train else \
            tp.align_relu_kinks(tmod, tp.jax_bn_outputs(
                state['intermediates']))
        with torch.no_grad():
            got = tmod(_t(feats), _t(coords), _t(mask), train=train)
        for h in hooks:
            h.remove()
    assert seen['flipped'] <= 8, seen
    assert tmod.conv1 == ['conv1_0', 'conv1_1']
    assert tmod.conv4_0a.weight.shape[:2] == (128, 128)
    for lvl, fields in ref['multi_scale'].items():
        for f in ('features', 'ids', 'mask', 'occ'):
            if f not in fields:
                continue
            g, r = got['multi_scale'][lvl][f], np.asarray(fields[f])
            if f == 'features':
                tp.assert_close(g, r, atol=1e-5 * max(1.0, np.abs(r).max())
                                if train else 1e-5, err_msg=f'{lvl} {f}')
            else:
                np.testing.assert_array_equal(g.numpy(), r,
                                              err_msg=f'{lvl} {f}')
    bev = np.asarray(ref['bev_features'])
    tp.assert_close(got['bev_features'], bev,
                    atol=1e-5 * max(1.0, np.abs(bev).max()) if train
                    else 1e-5)
    assert got['bev_features'].shape[-1] == 256
    if train:
        buffers = dict(tmod.named_buffers())
        stats = jax_tree_to_port(tmod, state['batch_stats'], 'batch_stats')
        assert len(stats) == 2 * (1 + 4 + 4 + 4 + 3 + 4 + 1)
        for k, r in stats.items():
            tp.assert_close(buffers[k], r, err_msg=k)
