"""Parity of the port's PV-RCNN keypoint modules (glenet_tpu_torch/models/
pfe.py, pointnet2_backbone.SharedMLP, box_utils.points_in_boxes) with
glenet_tpu/models/pfe.py on the CPU, numpy-drawn inputs and weights, f32.

  - bilinear_interpolate, inside the map and clamped at its edges;
  - sparse_level_points for a sparse and a dense level (centres and ids
    exact, rows rtol 1e-5), the dense rows at glenet_tpu's z-y-x ids;
  - StackSAModuleMSG in train mode with empty balls (whose rows of index 0
    go through the BN): outputs and BN running stats rtol 1e-4 / atol
    1e-5, the ball-query indices exact;
  - VoxelSetAbstraction on the toy PV-RCNN backbone's outputs (all six
    sources), in train and eval mode: keypoints exact, features and BN
    stats rtol 1e-4 / atol 1e-5;
  - keypoint segmentation targets exact, keypoint_seg_loss and
    PointHeadSimple rtol 1e-4."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from glenet_tpu.models import pfe as jpfe  # noqa: E402
from glenet_tpu.ops import pointnet2 as jpn2  # noqa: E402

from glenet_tpu_torch.models import pfe  # noqa: E402
from glenet_tpu_torch.ops import pointnet2 as pn2  # noqa: E402
from glenet_tpu_torch.utils.jax_weights import (  # noqa: E402
    jax_tree_to_port, load_jax_variables)


def _stats_equal(module, ref_stats):
    buffers = dict(module.named_buffers())
    stats = jax_tree_to_port(module, ref_stats, 'batch_stats')
    assert len(stats) == len(buffers)
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _init(module, seed, *args, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kw))
    return tp.random_variables(shapes, seed)


def test_bilinear_interpolate():
    rng = np.random.RandomState(0)
    im = rng.randn(6, 9, 4).astype(np.float32)
    x = rng.uniform(-1.5, 10.5, 50).astype(np.float32)
    y = rng.uniform(-1.5, 7.5, 50).astype(np.float32)
    ref = np.asarray(jpfe.bilinear_interpolate(
        jnp.asarray(im), jnp.asarray(x), jnp.asarray(y)))
    got = pfe.bilinear_interpolate(torch.from_numpy(im), torch.from_numpy(x),
                                   torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def _levels(seed, b=2):
    """A sparse level (ids sorted, sentinel in masked slots) and a dense
    one (features (B, D, H, W, C) with an active-site list)."""
    rng = np.random.RandomState(seed)
    grid = (8, 6, 5)                                     # nx, ny, nz
    n_cells = int(np.prod(grid))
    out = {}
    for kind, cap, stride in (('sparse', 40, 2), ('dense', 30, 4)):
        ids = np.full((b, cap), n_cells, np.int32)
        mask = np.zeros((b, cap), bool)
        for i in range(b):
            n = cap - 5 - 3 * i
            ids[i, :n] = np.sort(rng.choice(n_cells, n, replace=False))
            mask[i, :n] = True
        if kind == 'sparse':
            feats = rng.randn(b, cap, 3).astype(np.float32)
        else:
            feats = rng.randn(b, grid[2], grid[1], grid[0], 3).astype(
                np.float32)
        out[kind] = {'kind': kind, 'features': feats, 'ids': ids,
                     'mask': mask, 'grid': grid, 'stride': stride}
    return out


def _port_level(level):
    feats = torch.from_numpy(level['features'])
    if level['kind'] == 'dense':
        # the port's dense levels are channels-last views of NCDHW tensors
        feats = feats.permute(0, 4, 1, 2, 3).contiguous().permute(
            0, 2, 3, 4, 1)
    return dict(level, features=feats, ids=torch.from_numpy(level['ids']),
                mask=torch.from_numpy(level['mask']))


def _jax_level(level):
    return dict(level, **{k: jnp.asarray(level[k])
                          for k in ('features', 'ids', 'mask')})


@pytest.mark.parametrize('kind', ['sparse', 'dense'])
def test_sparse_level_points(kind):
    level = _levels(1)[kind]
    vs, pcr = (0.2, 0.25, 0.3), (-1.0, -2.0, -3.0, 5.0, 5.0, 5.0)
    ref = jax.tree.map(np.asarray, jpfe.sparse_level_points(
        _jax_level(level), vs, pcr))
    got = pfe.sparse_level_points(_port_level(level), vs, pcr)
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-5)
    if kind == 'dense':
        # row k of sample 0 is the cell at z-y-x linear id ids[0, k]
        nx, ny, _ = level['grid']
        i = level['ids'][0, 0]
        z, y, x = i // (nx * ny), (i // nx) % ny, i % nx
        np.testing.assert_array_equal(got[1][0, 0].numpy(),
                                      level['features'][0, z, y, x])
        assert not got[1][~torch.from_numpy(level['mask'])].any()


def _sa_inputs(seed, b=2, n=200, m=40, c=3):
    rng = np.random.RandomState(seed)
    src = rng.uniform(-2, 2, (b, n, 3)).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.2
    kp = rng.uniform(-2, 2, (b, m, 3)).astype(np.float32)
    kp[:, :8] += 30.0                                   # empty balls
    kp[:, 8:16] = src[:, :8]                            # on points
    mask[:, :8] = True
    return kp, src, feats, mask


def test_stack_sa_module_train_mode_with_empty_balls():
    radii, nsamples, mlps = (0.5, 1.0), (8, 16), ((8, 8), (8, 16))
    kp, src, feats, mask = _sa_inputs(2)
    jm = jpfe.StackSAModuleMSG(radii=radii, nsamples=nsamples, mlps=mlps)
    args = tuple(jnp.asarray(a) for a in (kp, src, feats, mask))
    variables = _init(jm, 3, *args, train=True)
    ref, new_state = jax.tree.map(np.asarray, jm.apply(
        jax.tree.map(jnp.asarray, variables), *args, train=True,
        mutable=['batch_stats']))
    tm = pfe.StackSAModuleMSG(3, radii, nsamples, mlps)
    load_jax_variables(tm, variables)
    targs = tuple(torch.from_numpy(a) for a in (kp, src, feats, mask))
    got = tm(*targs, train=True)
    tp.assert_close(got.detach(), ref)
    _stats_equal(tm, new_state['batch_stats'])
    for r, s in zip(radii, nsamples):
        ref_idx, ref_empty = jax.tree.map(np.asarray, jax.vmap(
            lambda x, nx, mk: jpn2.ball_query(r, s, x, nx, mk))(
            args[1], args[0], args[3]))
        idx, empty = pn2.ball_query(r, s, targs[1], targs[0], targs[3])
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_array_equal(empty.numpy(), ref_empty)
        assert ref_empty[:, :8].all() and not ref_empty[:, 8:16].any()
    assert not got[:, :8].any()


@pytest.fixture(scope='module')
def vsa_case():
    """The toy PV-RCNN's backbone outputs on 512-point scenes with
    intensities (the port's backbone, which test_torch_pvrcnn.py holds to
    glenet_tpu's), as numpy, and the VoxelSetAbstraction config."""
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = tp.tiny_pvrcnn_cfg()
    tcfg = tp.to_port_cfg(cfg)
    det = build_detector(tcfg, device='cpu')
    rng = np.random.RandomState(4)
    pts = np.zeros((2, 512, 4), np.float32)
    pts[..., 0] = rng.uniform(0, 16, (2, 512))
    pts[..., 1] = rng.uniform(-8, 8, (2, 512))
    pts[..., 2] = rng.uniform(-1.1, 1.1, (2, 512))
    pts[..., 3] = rng.uniform(0, 1, (2, 512))
    mask = np.ones((2, 512), bool)
    mask[1, 400:] = False
    with tp.pinned_f32(), torch.no_grad():
        vox = det.net.voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                               det.max_voxels_test)
        sp = det.net.backbone_3d(det.net.vfe(vox['voxels'],
                                             vox['voxel_num_points']),
                                 vox['voxel_coords'], vox['voxel_mask'])
    ms = {}
    for k, lv in sp['multi_scale'].items():
        ms[k] = {key: (v.contiguous().numpy() if torch.is_tensor(v) else v)
                 for key, v in lv.items() if key != 'occ'}
    return (cfg, det, pts, mask, ms,
            sp['bev_features'].contiguous().numpy())


@pytest.mark.parametrize('train', [True, False])
def test_voxel_set_abstraction(vsa_case, train):
    cfg, det, pts, mask, ms, bev = vsa_case
    pfe_cfg = cfg.MODEL.PFE
    jm = jpfe.VoxelSetAbstraction(model_cfg=pfe_cfg,
                                  voxel_size=det.voxel_size,
                                  pc_range=det.pc_range)
    jms = {k: dict(v, **{key: jnp.asarray(v[key])
                         for key in ('features', 'ids', 'mask')})
           for k, v in ms.items()}
    args = (jnp.asarray(pts), jnp.asarray(mask), jms, jnp.asarray(bev), 8)
    variables = _init(jm, 5, *args, train=True)
    ref, new_state = jm.apply(jax.tree.map(jnp.asarray, variables), *args,
                              train=train, mutable=['batch_stats'])
    ref = jax.tree.map(np.asarray, ref)
    tm = pfe.VoxelSetAbstraction(
        tp.to_port_cfg(cfg).MODEL.PFE, det.voxel_size, det.pc_range,
        bev.shape[-1], 4, det.net.backbone_3d.level_channels)
    load_jax_variables(tm, variables)
    tms = {k: _port_level(v) if v['kind'] == 'dense' else dict(
        v, **{key: torch.from_numpy(v[key])
              for key in ('features', 'ids', 'mask')})
        for k, v in ms.items()}
    got = tm(torch.from_numpy(pts), torch.from_numpy(mask), tms,
             torch.from_numpy(bev), 8, train=train)
    np.testing.assert_array_equal(got['keypoints'].numpy(), ref['keypoints'])
    for k in ('point_features_before_fusion', 'point_features'):
        tp.assert_close(got[k].detach(), ref[k], err_msg=k)
    if train:
        _stats_equal(tm, jax.tree.map(np.asarray, new_state['batch_stats']))
    # every source gave features, the keypoints lie on valid points
    assert got['point_features_before_fusion'].shape[-1] == (
        tm.num_features_before_fusion)
    assert mask[np.arange(2)[:, None], got['keypoint_idx'].numpy()].all()


def test_keypoint_targets_loss_and_head():
    rng = np.random.RandomState(6)
    b, k, m = 2, 300, 5
    kp = rng.uniform(-10, 10, (b, k, 3)).astype(np.float32)
    gt = np.zeros((b, m, 8), np.float32)
    gt[..., :3] = rng.uniform(-8, 8, (b, m, 3))
    gt[..., 3:6] = rng.uniform(2, 6, (b, m, 3))
    gt[..., 6] = rng.uniform(-3, 3, (b, m))
    gt_mask = np.ones((b, m), bool)
    gt_mask[1, 3:] = False
    ref_labels = np.asarray(jax.vmap(jpfe.assign_keypoint_seg_targets)(
        jnp.asarray(kp), jnp.asarray(gt), jnp.asarray(gt_mask)))
    labels = pfe.assign_keypoint_seg_targets(
        torch.from_numpy(kp), torch.from_numpy(gt), torch.from_numpy(gt_mask))
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    assert set(np.unique(ref_labels)) == {-1, 0, 1}

    feats = rng.randn(b, k, 12).astype(np.float32)
    jm = jpfe.PointHeadSimple(num_class=1, cls_fc=(16, 8))
    variables = _init(jm, 7, jnp.asarray(feats), train=True)
    ref_cls, new_state = jax.tree.map(np.asarray, jm.apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(feats), train=True,
        mutable=['batch_stats']))
    tm = pfe.PointHeadSimple(12, 1, (16, 8))
    load_jax_variables(tm, variables)
    cls = tm(torch.from_numpy(feats), train=True)
    tp.assert_close(cls.detach(), ref_cls)
    _stats_equal(tm, new_state['batch_stats'])

    ref_loss = float(jpfe.keypoint_seg_loss(
        jnp.asarray(ref_cls).reshape(-1, 1), jnp.asarray(ref_labels).reshape(
            -1)))
    loss = pfe.keypoint_seg_loss(torch.from_numpy(ref_cls).reshape(-1, 1),
                                 torch.from_numpy(ref_labels).reshape(-1))
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-4)
