"""PartA2's modules in the port against glenet_tpu, one set of numpy-drawn
inputs and weights through both, f32 on both sides:

  - the row tables of UNetV2's (3, 1, 1) conv_out and inverse convs
    (strided_gather_table, inverse_gather_table): integers exact;
  - gather_gemm_b, whole and K-chunked (GATHER_BYTES_BUDGET lowered in
    both packages), and to_dense: forward and gradients rtol 1e-5;
  - InverseConvBN and UNetV2 at a toy grid in train mode: every level's
    ids and masks exact, features rtol 1e-4 / atol 1e-5 (two dozen convs
    with batch-moment BN in f32, summed in another order);
  - roiaware_pool3d, max and avg, on points whose features and positions
    tie: forward and gradients rtol 1e-5 / atol 1e-6;
  - assign_part_targets and assign_point_targets: exact labels and masks,
    part locations and box encodings rtol 1e-5 / atol 1e-6;
  - PointResidualCoder encode and decode: rtol 1e-6 / atol 1e-6;
  - PartA2FCHead in eval mode and in train mode (JAX's dropout draws fed
    to the port): outputs rtol 1e-4 / atol 1e-5, BN stats rtol 1e-4 /
    atol 1e-5."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from glenet_tpu.ops import sparse as jsp  # noqa: E402

from glenet_tpu_torch.ops import sparse as tsp  # noqa: E402
from glenet_tpu_torch.utils.jax_weights import (  # noqa: E402
    jax_tree_to_port, load_jax_variables)

GRID = (10, 8, 7)                 # (nx, ny, nz)
N_CELLS = 560


def _sites(seed, grid=GRID, n_active=(50, 57), cap=64):
    """Sorted active ids (sentinel n_cells) and masks, (B, cap)."""
    n_cells = int(np.prod(grid))
    ids, mask = [], []
    for s, n in enumerate(n_active):
        r = np.random.RandomState(seed * 10 + s)
        i = np.full((cap,), n_cells, np.int32)
        i[:n] = np.sort(r.choice(n_cells, size=n, replace=False))
        ids.append(i)
        mask.append(i < n_cells)
    return np.stack(ids), np.stack(mask)


def _out_sites(ids, mask, grid, ks, st, pad, cap):
    out = [jsp.strided_output_sites(jnp.asarray(i), jnp.asarray(m), grid, ks,
                                    st, pad, cap) for i, m in zip(ids, mask)]
    return (np.stack([np.asarray(o[0]) for o in out]),
            np.stack([np.asarray(o[1]) for o in out]))


@pytest.mark.parametrize('kind', ['strided_311', 'strided_333_pad011',
                                  'inverse_pad1', 'inverse_pad011'])
def test_row_tables(kind):
    """strided_gather_table / inverse_gather_table equal JAX's exactly,
    padding rows included."""
    ids, mask = _sites(1)
    if kind.startswith('strided'):
        ks, st, pad = (((3, 1, 1), (2, 1, 1), 0) if kind.endswith('311')
                       else (3, 2, (0, 1, 1)))
        oid, om = _out_sites(ids, mask, GRID, ks, st, pad, 48)
        for b in range(2):
            want = jsp.strided_gather_table(
                jnp.asarray(ids[b]), jnp.asarray(mask[b]), jnp.asarray(oid[b]),
                jnp.asarray(om[b]), GRID, ks, st, pad)
            got = tsp.strided_gather_table(
                torch.from_numpy(ids[b]), torch.from_numpy(mask[b]),
                torch.from_numpy(oid[b]), torch.from_numpy(om[b]), GRID, ks,
                st, pad)
            assert (np.asarray(want) < 64).any()
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    pad = 1 if kind.endswith('pad1') else (0, 1, 1)
    cid, cm = _out_sites(ids, mask, GRID, 3, 2, pad, 48)
    for b in range(2):
        want = jsp.inverse_gather_table(
            jnp.asarray(ids[b]), jnp.asarray(mask[b]), jnp.asarray(cid[b]),
            jnp.asarray(cm[b]), GRID, 3, 2, pad)
        got = tsp.inverse_gather_table(
            torch.from_numpy(ids[b]), torch.from_numpy(mask[b]),
            torch.from_numpy(cid[b]), torch.from_numpy(cm[b]), GRID, 3, 2,
            pad)
        assert (np.asarray(want) < 48).any()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('budget', [None, 4096])
def test_gather_gemm_b(budget, monkeypatch):
    """The row-table contraction, whole and consumed in K chunks (a budget
    of 4096 bytes gives 2-tap chunks here), and its gradients."""
    ids, mask = _sites(2)
    cid, cm = _out_sites(ids, mask, GRID, 3, 2, 1, 48)
    table = np.stack([np.asarray(jsp.inverse_gather_table(
        jnp.asarray(ids[b]), jnp.asarray(mask[b]), jnp.asarray(cid[b]),
        jnp.asarray(cm[b]), GRID, 3, 2, 1)) for b in range(2)])
    r = np.random.RandomState(3)
    feats = np.where(cm[..., None], r.randn(2, 48, 4), 0).astype(np.float32)
    w = (r.randn(27, 4, 5) * 0.3).astype(np.float32)
    cot = r.randn(2, 64, 5).astype(np.float32)
    monkeypatch.setattr(jsp, 'GATHER_COMPUTE_DTYPE', None)
    monkeypatch.setattr(tsp, 'GATHER_COMPUTE_DTYPE', None)
    if budget is not None:
        monkeypatch.setattr(jsp, 'GATHER_BYTES_BUDGET', budget)
        monkeypatch.setattr(tsp, 'GATHER_BYTES_BUDGET', budget)

    def jf(f, w_):
        return jsp.gather_gemm_b(f, jnp.asarray(table), w_)

    want, vjp = jax.vjp(jf, jnp.asarray(feats), jnp.asarray(w))
    dwant = vjp(jnp.asarray(cot))
    tf = torch.from_numpy(feats).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tsp.gather_gemm_b(tf, torch.from_numpy(table), tw)
    got.backward(torch.from_numpy(cot))
    for a, b in ((got, want), (tf.grad, dwant[0]), (tw.grad, dwant[1])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_to_dense():
    ids, mask = _sites(4)
    feats = np.random.RandomState(5).randn(2, 64, 3).astype(np.float32)
    for b in range(2):
        want = jsp.to_dense(jnp.asarray(feats[b]), jnp.asarray(ids[b]),
                            jnp.asarray(mask[b]), GRID)
        got = tsp.to_dense(torch.from_numpy(feats[b]),
                           torch.from_numpy(ids[b]),
                           torch.from_numpy(mask[b]), GRID)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _apply_train(module, variables, *args, static=(), pick=None):
    """module.apply in train mode, jitted (args at the `static` positions
    are static) -> (outputs, or their arrays `pick` selects; new
    batch_stats)."""
    def run(v, *a):
        out, state = module.apply(v, *a, train=True, mutable=['batch_stats'])
        return (out if pick is None else pick(out)), state['batch_stats']

    return jax.jit(run, static_argnums=tuple(i + 1 for i in static))(
        variables, *args)


def test_inverse_conv_bn():
    """InverseConvBN in train mode: outputs and BN statistics."""
    from glenet_tpu.models.spconv_backbone import InverseConvBN as JInv

    from glenet_tpu_torch.models.spconv_backbone import InverseConvBN
    ids, mask = _sites(6)
    cid, cm = _out_sites(ids, mask, GRID, 3, 2, (0, 1, 1), 48)
    feats = np.where(cm[..., None], np.random.RandomState(7).randn(2, 48, 6),
                     0).astype(np.float32)
    jmod = JInv(5, 3, 2, (0, 1, 1))
    args = (jnp.asarray(feats), jnp.asarray(cid), jnp.asarray(cm),
            jnp.asarray(ids), jnp.asarray(mask), GRID)
    with tp.pinned_f32():
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                                  *args, train=True))
        variables = tp.random_variables(shapes, seed=8)
        want, stats = _apply_train(jmod, variables, *args, static=(5,))
        tmod = InverseConvBN(6, 5, 3, 2, (0, 1, 1))
        load_jax_variables(tmod, variables)
        got = tmod(*(torch.from_numpy(np.array(a)) for a in args[:5]),
                   GRID, train=True)
    tp.assert_close(got.detach(), want, rtol=1e-4, atol=1e-5)
    bufs = dict(tmod.named_buffers())
    for k, v in jax_tree_to_port(tmod, stats, 'batch_stats').items():
        tp.assert_close(bufs[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


UNET_GRID = (24, 24, 12)          # raw (nx, ny, nz): sparse z is 13


def _unet_inputs(seed, v=160, n_active=(150, 131)):
    nx, ny, nz = UNET_GRID
    coords = np.zeros((2, v, 3), np.int32)
    mask = np.zeros((2, v), bool)
    r = np.random.RandomState(seed)
    for b, n in enumerate(n_active):
        cells = np.sort(r.choice(nx * ny * nz, size=n, replace=False))
        z, rem = cells // (ny * nx), cells % (ny * nx)
        coords[b, :n] = np.stack([z, rem // nx, rem % nx], -1)
        mask[b, :n] = True
    feats = np.where(mask[..., None], r.randn(2, v, 4), 0).astype(np.float32)
    return feats, coords, mask


def _unet_arrays(out):
    return {'multi_scale': {k: {n: v[n] for n in ('features', 'ids', 'mask')}
                            for k, v in out['multi_scale'].items()},
            **{k: out[k] for k in ('point_features', 'point_coords',
                                   'bev_features')}}


def test_unetv2_levels():
    """UNetV2 in train mode at a toy grid: each level's ids and masks
    exact, features, the decoder's voxel-point features, the voxel centres,
    the BEV map and every BN statistic close."""
    from glenet_tpu.models.spconv_backbone import UNetV2 as JUNet

    from glenet_tpu_torch.models.spconv_backbone import UNetV2
    feats, coords, mask = _unet_inputs(9)
    vs, pcr = (0.5, 0.5, 0.2), (0.0, -4.0, -1.2, 8.0, 4.0, 1.2)
    jmod = JUNet(grid_size=UNET_GRID, max_voxels=160, voxel_size=vs,
                 pc_range=pcr)
    args = tuple(jnp.asarray(a) for a in (feats, coords, mask))
    with tp.pinned_f32():
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                                  *args, train=True))
        variables = tp.random_variables(shapes, seed=10)
        want, stats = _apply_train(jmod, variables, *args, pick=_unet_arrays)
        tmod = UNetV2(UNET_GRID, vs, pcr)
        load_jax_variables(tmod, variables)
        got = tmod(*(torch.from_numpy(a) for a in (feats, coords, mask)),
                   train=True)
    g = (UNET_GRID[0], UNET_GRID[1], UNET_GRID[2] + 1)
    grids = {'x_conv1': g}
    for lvl, pad in ((2, 1), (3, 1), (4, (0, 1, 1))):
        g = grids[f'x_conv{lvl}'] = jsp.out_grid_size(g, 3, 2, pad)
    for lvl in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4'):
        w, g = want['multi_scale'][lvl], got['multi_scale'][lvl]
        assert tuple(grids[lvl]) == tuple(g['grid']), lvl
        np.testing.assert_array_equal(g['ids'].numpy(), np.asarray(w['ids']))
        np.testing.assert_array_equal(g['mask'].numpy(),
                                      np.asarray(w['mask']))
        assert np.asarray(w["mask"]).sum() > 12, lvl
        tp.assert_close(g['features'].detach(), w['features'], rtol=1e-4,
                        atol=1e-5, err_msg=lvl)
    for key in ('point_features', 'point_coords', 'bev_features'):
        tp.assert_close(got[key].detach(), want[key], rtol=1e-4, atol=1e-5,
                        err_msg=key)
    assert got['num_bev_features'] == want['bev_features'].shape[-1]
    bufs = dict(tmod.named_buffers())
    port_stats = jax_tree_to_port(tmod, stats, 'batch_stats')
    assert len(port_stats) == len(bufs)
    for k, v in port_stats.items():
        tp.assert_close(bufs[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def _pool_case(seed):
    """Points on a coarse lattice with features from {0, 1, 2} (so cells
    hold tied maxima, as after a ReLU), 12 of them repeated; 4 rotated rois,
    the last out of the scene."""
    r = np.random.RandomState(seed)
    p, c = 300, 5
    pts = np.stack([r.uniform(0, 12, p), r.uniform(-6, 6, p),
                    r.uniform(-1, 1, p)], -1)
    pts = np.round(pts * 4) / 4
    pts[-12:] = pts[:12]
    feats = r.randint(0, 3, (p, c)).astype(np.float32)
    rois = np.array([[3.0, 0.0, 0.0, 4.0, 2.0, 1.6, 0.3],
                     [8.0, -2.0, 0.1, 3.5, 2.5, 1.8, -1.1],
                     [6.0, 2.5, -0.1, 5.0, 3.0, 2.0, 2.0],
                     [100.0, 0.0, 0.0, 4.0, 2.0, 1.6, 0.0]], np.float32)
    mask = r.uniform(size=p) > 0.1
    return (pts.astype(np.float32), feats, rois, mask,
            r.randn(4, 3, 3, 3, c).astype(np.float32))


@pytest.mark.parametrize('method', ['max', 'avg'])
def test_roiaware_pool3d(method):
    """Pooled grids and the features' gradient, with ties in the max pool
    (a cotangent split evenly among the tied points)."""
    from glenet_tpu.ops.roiaware_pool import roiaware_pool3d as jpool

    from glenet_tpu_torch.ops import roiaware_pool
    pts, feats, rois, mask, cot = _pool_case(11)

    def jf(f):
        return jpool(jnp.asarray(pts), f, jnp.asarray(rois), 3, method,
                     jnp.asarray(mask))

    want, vjp = jax.vjp(jf, jnp.asarray(feats))
    dwant = np.asarray(vjp(jnp.asarray(cot))[0])
    assert np.asarray(want).any() and not np.asarray(want)[3].any()
    if method == 'max':
        assert (dwant % 1 != 0).any(), 'the case must hold tied maxima'
    tf = torch.from_numpy(feats).requires_grad_()
    got = roiaware_pool.roiaware_pool3d(
        torch.from_numpy(pts), tf, torch.from_numpy(rois), 3, method,
        torch.from_numpy(mask))
    got.backward(torch.from_numpy(cot))
    tp.assert_close(got.detach(), want, rtol=1e-5, atol=1e-6)
    tp.assert_close(tf.grad, dwant, rtol=1e-5, atol=1e-6)


def _target_case():
    r = np.random.RandomState(12)
    pts = np.stack([r.uniform(0, 16, 400), r.uniform(-8, 8, 400),
                    r.uniform(-1.2, 1.2, 400)], -1).astype(np.float32)
    gt = np.zeros((5, 8), np.float32)
    gt[:4] = [[4.0, 0.0, -0.2, 3.9, 1.6, 1.56, 0.4, 1],
              [10.0, 3.0, 0.0, 0.8, 0.6, 1.73, -1.0, 2],
              [12.0, -4.0, 0.1, 1.76, 0.6, 1.73, 2.5, 3],
              [5.0, 0.5, -0.1, 3.0, 1.5, 1.5, 0.0, 1]]      # overlaps box 0
    gm = np.array([True, True, True, True, False])
    pts[:40] = gt[r.randint(0, 4, 40), :3] + r.uniform(-0.6, 0.6, (40, 3))
    pmask = r.uniform(size=400) > 0.05
    return pts, pmask, gt, gm


def test_assign_part_targets():
    from glenet_tpu.models import point_heads as jph

    from glenet_tpu_torch.models import point_heads
    pts, pmask, gt, gm = _target_case()
    seg, part, fg = jph.assign_part_targets(
        jnp.asarray(pts), jnp.asarray(pmask), jnp.asarray(gt),
        jnp.asarray(gm))
    tseg, tpart, tfg = point_heads.assign_part_targets(
        *(torch.from_numpy(a)[None] for a in (pts, pmask, gt, gm)))
    assert (np.asarray(seg) == 1).sum() > 20 and (np.asarray(seg) == -1).any()
    np.testing.assert_array_equal(tseg[0].numpy(), np.asarray(seg))
    np.testing.assert_array_equal(tfg[0].numpy(), np.asarray(fg))
    tp.assert_close(tpart[0], part, rtol=1e-5, atol=1e-6)


def test_assign_point_targets():
    from glenet_tpu.models import point_heads as jph
    from glenet_tpu.utils.box_coder import PointResidualCoder as JCoder

    from glenet_tpu_torch.models import point_heads
    from glenet_tpu_torch.utils.box_coder import build_box_coder
    mean = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
    pts, pmask, gt, gm = _target_case()
    cls, box_t, fg = jph.assign_point_targets(
        jnp.asarray(pts), jnp.asarray(pmask), jnp.asarray(gt),
        jnp.asarray(gm), JCoder(mean_size=tuple(map(tuple, mean))))
    coder = build_box_coder('PointResidualCoder', use_mean_size=True,
                            mean_size=mean)
    tcls, tbox, tfg = point_heads.assign_point_targets(
        *(torch.from_numpy(a)[None] for a in (pts, pmask, gt, gm)), coder)
    assert set(np.unique(np.asarray(cls))) == {-1, 0, 1, 2, 3}
    np.testing.assert_array_equal(tcls[0].numpy(), np.asarray(cls))
    np.testing.assert_array_equal(tfg[0].numpy(), np.asarray(fg))
    tp.assert_close(tbox[0], box_t, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('use_mean_size', [True, False])
def test_point_residual_coder(use_mean_size):
    from glenet_tpu.utils.box_coder import PointResidualCoder as JCoder

    from glenet_tpu_torch.utils.box_coder import build_box_coder
    mean = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73]]
    r = np.random.RandomState(13)
    boxes = np.concatenate([r.uniform(-10, 10, (50, 3)),
                            r.uniform(0.3, 4, (50, 3)),
                            r.uniform(-3, 3, (50, 1))], 1).astype(np.float32)
    pts = (boxes[:, :3] + r.uniform(-1, 1, (50, 3))).astype(np.float32)
    cls = r.randint(1, 3, 50)
    enc = r.randn(50, 8).astype(np.float32) * 0.3
    jc = JCoder(use_mean_size=use_mean_size,
                mean_size=tuple(map(tuple, mean)))
    tc = build_box_coder('PointResidualCoder', use_mean_size=use_mean_size,
                         mean_size=mean)
    t = [torch.from_numpy(a) for a in (boxes, pts, cls, enc)]
    tp.assert_close(tc.encode(t[0], t[1], t[2]),
                    jc.encode(jnp.asarray(boxes), jnp.asarray(pts),
                              jnp.asarray(cls)), rtol=1e-6, atol=1e-6)
    tp.assert_close(tc.decode(t[3], t[1], t[2]),
                    jc.decode(jnp.asarray(enc), jnp.asarray(pts),
                              jnp.asarray(cls)), rtol=1e-6, atol=1e-6)


def _head_case():
    """Two samples of 400 voxel points, 16 features (a ReLU output: a
    third are 0), part features and 6 rois around the points."""
    r = np.random.RandomState(14)
    coords = np.stack([r.uniform(0, 12, (2, 400)), r.uniform(-5, 5, (2, 400)),
                       r.uniform(-1, 1, (2, 400))], -1).astype(np.float32)
    feats = np.maximum(r.randn(2, 400, 16), 0).astype(np.float32)
    part = r.uniform(0, 1, (2, 400, 4)).astype(np.float32)
    mask = r.uniform(size=(2, 400)) > 0.1
    rois = np.concatenate([r.uniform([1, -4, -0.5], [11, 4, 0.5], (2, 6, 3)),
                           r.uniform([2, 1.2, 1.2], [5, 2.5, 2], (2, 6, 3)),
                           r.uniform(-3, 3, (2, 6, 1))], -1)
    return coords, feats, part, mask, rois.astype(np.float32)


@pytest.mark.parametrize('train', [False, True])
def test_parta2_fc_head(train):
    """PartA2FCHead on the toy config's head (4^3 grids, SHARED_FC 32 x 2,
    DP_RATIO 0.3): eval mode, and train mode with JAX's dropout draws fed
    to the port; outputs and BN statistics."""
    from flax import linen as nn
    from glenet_tpu.models.roi_heads import PartA2FCHead as JHead
    from test_parta2 import make_parta2_cfg

    from glenet_tpu_torch.models.roi_heads import PartA2FCHead
    roi_cfg = make_parta2_cfg().MODEL.ROI_HEAD
    args = tuple(jnp.asarray(a) for a in (_head_case()[4], *_head_case()[:4]))
    jmod = JHead(model_cfg=roi_cfg, code_size=7)
    with tp.pinned_f32():
        shapes = jax.eval_shape(lambda: jmod.init(
            {'params': jax.random.PRNGKey(0),
             'dropout': jax.random.PRNGKey(1)}, *args, train=True))
        variables = tp.random_variables(shapes, seed=15)
        want, state = jmod.apply(
            variables, *args, train=train,
            mutable=['batch_stats', 'intermediates'],
            capture_intermediates=lambda m, _: isinstance(m, nn.Dropout),
            rngs={'dropout': jax.random.PRNGKey(2)})
        tmod = PartA2FCHead(tp.to_port_cfg(roi_cfg), 16)
        load_jax_variables(tmod, variables)
        draws = (tp.jax_dropout_outputs({'roi_head': state['intermediates']})
                 if train else [])
        assert len(draws) == (3 if train else 0)
        with tp.fed_dropout(draws):
            got = tmod(*(torch.from_numpy(np.array(a)) for a in args),
                       train=train)
    for k in ('rcnn_cls', 'rcnn_reg'):
        tp.assert_close(got[k].detach(), want[k], rtol=1e-4, atol=1e-5,
                        err_msg=k)
    if train:
        bufs = dict(tmod.named_buffers())
        for k, v in jax_tree_to_port(tmod, state['batch_stats'],
                                     'batch_stats').items():
            tp.assert_close(bufs[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
