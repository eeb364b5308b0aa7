"""PointRCNN's modules in the port against glenet_tpu, one set of
numpy-drawn inputs and weights through both, f32 on both sides:

  - SetAbstractionMSG (on a scene with padded points and on one whose
    points are all invalid, so every ball is empty), FeaturePropagation and
    PointNet2MSG at the toy widths of tests/test_pointrcnn.py
    (TINY_POINTRCNN) in train mode: centres, masks and every integer
    exact; features rtol 1e-4 / atol 1e-5; BN statistics rtol 1e-4 / atol
    1e-5; the gradients of one level (a random cotangent) per tensor max
    |diff| <= 2e-4 max |grad| + 1e-6.  XLA's CPU reductions sum in order,
    so glenet_tpu's f32 BN moments carry more rounding than torch's
    (pairwise) ones: with every ball of a sample empty, half the rows are
    one repeated row and JAX's features stray 1.2e-4 from an f64 run of
    the port (the port's f32: 2.2e-6).  There the atol also takes twice
    JAX's own rounding, measured as the difference between its outputs
    and its outputs on the samples swapped (equal in exact arithmetic);
  - three_nn chunked (CHUNK_ELEMENTS lowered) against one block and
    against glenet_tpu: indices exact, distances atol 1e-6;
  - PointHeadBox with padded points: outputs and BN statistics as above;
  - roipoint_pool3d with a partly masked cloud, rois holding more and
    fewer points than the slots (cyclic fill) and an empty roi: indices,
    pooled values and empty flags exact;
  - SetAbstractionSSG (a ball level and the group-all level, empty rois
    included) and PointRCNNHead (eval mode, and train mode with DP_RATIO
    0.3 and JAX's dropout draws fed to the port): outputs rtol 1e-4 / atol
    1e-5, BN statistics as above;
  - the RoI sampler's CLS_SCORE_TYPE cls labels (1 above CLS_FG_THRESH, 0
    up to CLS_BG_THRESH, -1 between) on JAX's own draws: exact, on cases
    whose IoUs lie more than 1e-4 from every threshold."""
import copy

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from test_pointrcnn import TINY_POINTRCNN, make_two_stage_cfg  # noqa: E402

from glenet_tpu_torch.utils.jax_weights import (  # noqa: E402
    jax_tree_to_port, load_jax_variables)

SA = TINY_POINTRCNN.MODEL.BACKBONE_3D.SA_CONFIG


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed, b=2, n=256, c=1, invalid='padded'):
    """(xyz (b, n, 3), features (b, n, c), mask (b, n)): points in a 6 x 4
    x 2 m box, a third of them in tight clusters; sample 1 padded (its
    last 40 slots invalid, at the origin) or, with invalid='scene', all
    invalid."""
    r = np.random.RandomState(seed)
    xyz = np.stack([r.uniform(0, 6, (b, n)), r.uniform(-2, 2, (b, n)),
                    r.uniform(-1, 1, (b, n))], -1)
    k = n // 3
    centres = r.uniform([1, -1, -0.5], [5, 1, 0.5], (b, 4, 3))
    xyz[:, :k] = (centres[:, r.randint(0, 4, k)]
                  + r.randn(b, k, 3) * 0.15)
    feats = r.uniform(0, 1, (b, n, c))
    mask = np.ones((b, n), bool)
    if invalid == 'scene':
        mask[1] = False
    else:
        mask[1, -40:] = False
        xyz[1, -40:] = 0.0
    return xyz.astype(np.float32), feats.astype(np.float32), mask


def _init(jmod, *args, seed):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args,
                                              train=True))
    return tp.random_variables(shapes, seed=seed)


def _train(jmod, variables, *args):
    """jmod.apply in train mode, jitted -> (outputs, new batch_stats)."""
    def run(v, *a):
        out, st = jmod.apply(v, *a, train=True, mutable=['batch_stats'])
        return out, st.get('batch_stats', {})

    return jax.tree.map(np.asarray, jax.jit(run)(variables, *args))


def _assert_stats(tmod, stats):
    bufs = dict(tmod.named_buffers())
    port = jax_tree_to_port(tmod, stats, 'batch_stats')
    assert len(port) == len([k for k in bufs if k.endswith('running_mean')
                             or k.endswith('running_var')])
    for k, v in port.items():
        tp.assert_close(bufs[k], v, err_msg=k)


def _assert_grads(tmod, variables, jax_loss, port_loss):
    """Gradients of a scalar of the outputs w.r.t. every parameter."""
    want = jax.tree.map(np.asarray, jax.grad(jax_loss)(
        jax.tree.map(jnp.asarray, variables['params'])))
    tmod.zero_grad()
    port_loss().backward()
    got = {n: p.grad for n, p in tmod.named_parameters()}
    ref = jax_tree_to_port(tmod, want)
    assert set(ref) == set(got)
    for k, g_ref in ref.items():
        err = np.abs(got[k].numpy() - g_ref).max()
        assert err <= 2e-4 * np.abs(g_ref).max() + 1e-6, (k, err)


@pytest.mark.parametrize('invalid', ['padded', 'scene'])
def test_set_abstraction_msg(invalid):
    """The first level of TINY_POINTRCNN (128 centres, radii 0.5 / 1.0, 8 /
    16 samples, MLPs [8, 8]) in train mode, and its gradients; with
    invalid='scene' every ball of sample 1 is empty: its centres keep the
    gathered mask (False), BN counts its rows, its features are 0."""
    from glenet_tpu.models.pointnet2_backbone import SetAbstractionMSG as J

    from glenet_tpu_torch.models.pointnet2_backbone import SetAbstractionMSG
    xyz, feats, mask = _cloud(1, invalid=invalid)
    args = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(mask))
    jmod = J(npoint=SA.NPOINTS[0], radii=tuple(SA.RADIUS[0]),
             nsamples=tuple(SA.NSAMPLE[0]),
             mlps=tuple(tuple(m) for m in SA.MLPS[0]))
    cot = np.random.RandomState(2).randn(2, SA.NPOINTS[0], 16).astype(
        np.float32)
    with tp.pinned_f32():
        variables = _init(jmod, *args, seed=3)
        (nx, nf, nm), stats = _train(jmod, variables, *args)
        # the same level on the samples swapped: equal in exact arithmetic,
        # its difference is glenet_tpu's own f32 rounding
        swapped = _train(jmod, variables, *(a[::-1] for a in args))
        noise = np.abs(swapped[0][1][::-1] - nf).max()
        tmod = SetAbstractionMSG(1, SA.NPOINTS[0], SA.RADIUS[0],
                                 SA.NSAMPLE[0], SA.MLPS[0])
        load_jax_variables(tmod, variables)
        gx, gf, gm = tmod(_t(xyz), _t(feats), _t(mask), train=True)
        np.testing.assert_array_equal(gx.numpy(), nx)
        np.testing.assert_array_equal(gm.numpy(), nm)
        assert nm[0].all() and (invalid == 'padded') == nm[1].all()
        tp.assert_close(gf.detach(), nf, atol=1e-5 + 2 * noise)
        if invalid == 'scene':
            assert not nf[1].any()
        _assert_stats(tmod, stats)

        def jax_loss(p):
            out, _ = jmod.apply({'params': p,
                                 'batch_stats': variables['batch_stats']},
                                *args, train=True, mutable=['batch_stats'])
            return (out[1] * cot).sum()

        load_jax_variables(tmod, variables)
        _assert_grads(tmod, variables, jax_loss, lambda: (tmod(
            _t(xyz), _t(feats), _t(mask), train=True)[1] * _t(cot)).sum())


def test_feature_propagation():
    """An FP level (interpolation from 32 masked centres to 256 points,
    MLP [16, 16] with BN over the valid points) and its gradients."""
    from glenet_tpu.models.pointnet2_backbone import (
        FeaturePropagation as J)

    from glenet_tpu_torch.models.pointnet2_backbone import FeaturePropagation
    xyz, feats, mask = _cloud(4, c=8)
    r = np.random.RandomState(5)
    idx = np.stack([r.choice(216, 32, replace=False) for _ in range(2)])
    xyz_from = np.take_along_axis(xyz, idx[..., None], 1)
    mask_from = np.take_along_axis(mask, idx, 1)
    mask_from[0, -3:] = False
    feats_from = r.randn(2, 32, 12).astype(np.float32)
    arrays = (xyz, feats, mask, xyz_from, feats_from, mask_from)
    args = tuple(jnp.asarray(a) for a in arrays)
    jmod = J(mlp=(16, 16))
    cot = r.randn(2, 256, 16).astype(np.float32)
    with tp.pinned_f32():
        variables = _init(jmod, *args, seed=6)
        want, stats = _train(jmod, variables, *args)
        tmod = FeaturePropagation(8 + 12, (16, 16))
        load_jax_variables(tmod, variables)
        got = tmod(*(_t(a) for a in arrays), train=True)
        tp.assert_close(got.detach(), want)
        assert not want[1, -40:].any()
        _assert_stats(tmod, stats)

        def jax_loss(p):
            out, _ = jmod.apply({'params': p,
                                 'batch_stats': variables['batch_stats']},
                                *args, train=True, mutable=['batch_stats'])
            return (out * cot).sum()

        load_jax_variables(tmod, variables)
        _assert_grads(tmod, variables, jax_loss, lambda: (tmod(
            *(_t(a) for a in arrays), train=True) * _t(cot)).sum())


def test_pointnet2_msg():
    """TINY_POINTRCNN's PointNet2MSG (4 SA and 4 FP levels) in train mode
    on padded points with intensities: per-point features (atol with twice
    JAX's own rounding, as above: 16 BN layers deep it reaches 1e-4) and
    every BN statistic."""
    from glenet_tpu.models.pointnet2_backbone import PointNet2MSG as J

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.models.pointnet2_backbone import PointNet2MSG
    bb = TINY_POINTRCNN.MODEL.BACKBONE_3D
    xyz, feats, mask = _cloud(7, n=512)
    points = np.concatenate([xyz, feats], -1)
    jmod = J(sa_npoints=tuple(SA.NPOINTS),
             sa_radii=tuple(tuple(x) for x in SA.RADIUS),
             sa_nsamples=tuple(tuple(x) for x in SA.NSAMPLE),
             sa_mlps=tuple(tuple(tuple(m) for m in lv) for lv in SA.MLPS),
             fp_mlps=tuple(tuple(m) for m in bb.FP_MLPS))
    args = (jnp.asarray(points), jnp.asarray(mask))
    with tp.pinned_f32():
        variables = _init(jmod, *args, seed=8)
        want, stats = _train(jmod, variables, *args)
        noise = np.abs(_train(jmod, variables, *(a[::-1] for a in args))[0]
                       [::-1] - want).max()
        tmod = PointNet2MSG(Cfg(tp.to_port_cfg(TINY_POINTRCNN).MODEL
                                .BACKBONE_3D), 4)
        load_jax_variables(tmod, variables)
        got = tmod(_t(points), _t(mask), train=True)
    assert tmod.num_point_features == bb.FP_MLPS[0][-1]
    tp.assert_close(got.detach(), want, atol=1e-5 + 2 * noise)
    _assert_stats(tmod, stats)


def test_three_nn_chunked(monkeypatch):
    """three_nn over 4 chunks equals one block and glenet_tpu, near ties
    included (knowns on a lattice, unknowns at lattice midpoints)."""
    from glenet_tpu.ops import pointnet2 as jpn

    from glenet_tpu_torch.ops import pointnet2 as tpn
    r = np.random.RandomState(9)
    grid = np.stack(np.meshgrid(np.arange(6), np.arange(4), np.arange(2),
                                indexing='ij'), -1).reshape(-1, 3)
    known = np.stack([grid, grid[::-1]]).astype(np.float32) * 0.5
    unknown = np.concatenate([known[:, :20] + 0.25,
                              r.uniform(0, 3, (2, 80, 3))], 1).astype(
        np.float32)
    kmask = np.ones((2, 48), bool)
    kmask[1, ::5] = False
    whole = tpn.three_nn(_t(unknown), _t(known), _t(kmask))
    monkeypatch.setattr(tpn, 'CHUNK_ELEMENTS', 2 * 48 * 25)
    chunked = tpn.three_nn(_t(unknown), _t(known), _t(kmask))
    want = jax.vmap(jpn.three_nn)(jnp.asarray(unknown), jnp.asarray(known),
                                  jnp.asarray(kmask))
    for got in (whole, chunked):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-6)
    np.testing.assert_array_equal(chunked[0].numpy(), whole[0].numpy())


def test_point_head_box():
    """PointHeadBox (CLS_FC / REG_FC [32], 3 classes, code size 8) in train
    mode on padded points (BN over the valid ones): logits, box encodings
    and BN statistics."""
    from glenet_tpu.models.point_heads import PointHeadBox as J

    from glenet_tpu_torch.models.point_heads import PointHeadBox
    _, _, mask = _cloud(10)
    x = np.random.RandomState(11).randn(2, 256, 16).astype(np.float32)
    jmod = J(num_class=3, code_size=8, cls_fc=(32,), reg_fc=(32,))
    args = (jnp.asarray(x), jnp.asarray(mask))
    with tp.pinned_f32():
        variables = _init(jmod, *args, seed=12)
        want, stats = _train(jmod, variables, *args)
        tmod = PointHeadBox(16, 3, 8, (32,), (32,))
        load_jax_variables(tmod, variables)
        got = tmod(_t(x), _t(mask), train=True)
    for k in ('point_cls_preds', 'point_box_preds'):
        tp.assert_close(got[k].detach(), want[k], err_msg=k)
    _assert_stats(tmod, stats)


def test_roipoint_pool3d():
    """Indices and pooled values equal glenet_tpu's: a roi with more hits
    than slots (the first in point order), rois with fewer (cyclic fill),
    an enlarged roi, an empty one, and masked points inside a roi."""
    from glenet_tpu.ops.roipoint_pool import roipoint_pool3d as jpool

    from glenet_tpu_torch.ops.roipoint_pool import roipoint_pool3d
    xyz, _, mask = _cloud(13, n=400, c=1)
    feats = np.random.RandomState(14).randn(2, 400, 5).astype(np.float32)
    rois = np.array([[[3.0, 0.0, 0.0, 4.0, 3.0, 2.0, 0.3],
                      [1.0, -1.5, 0.0, 0.8, 0.6, 1.0, -0.7],
                      [4.5, 1.0, 0.2, 0.5, 0.5, 0.5, 1.2],
                      [50.0, 0.0, 0.0, 4.0, 2.0, 1.6, 0.0]],
                     [[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0],
                      [2.0, 0.5, 0.0, 1.5, 1.0, 1.0, 2.5],
                      [5.0, -1.0, -0.3, 1.0, 2.0, 1.2, -2.0],
                      [3.0, 0.0, 0.0, 6.0, 4.0, 2.0, 0.0]]], np.float32)
    extra = (0.2, 0.1, 0.3)
    got, got_empty = roipoint_pool3d(_t(xyz), _t(feats), _t(rois), 32,
                                     extra, _t(mask))
    want, want_empty = jax.vmap(lambda x, f, r, m: jpool(
        x, f, r, 32, extra_width=extra, points_mask=m))(
        jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(rois),
        jnp.asarray(mask))
    np.testing.assert_array_equal(got_empty.numpy(), np.asarray(want_empty))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the cases the rois were placed for: more hits than slots, fewer
    # (cyclic), none, and masked points inside roi (1, 0)
    from glenet_tpu_torch.utils import box_utils
    big = rois.copy()
    big[..., 3:6] += extra
    inside = box_utils.points_in_boxes(_t(xyz), _t(big))
    count = (inside & _t(mask)[..., None]).sum(1).numpy()
    assert (count > 32).any() and ((count > 0) & (count < 32)).any()
    assert (count == 0).any() and bool((inside[1, :, 0] & ~_t(mask)[1])
                                       .any())


def _ssg_case(seed, s=32, c=6):
    """Pooled-like rois (12 rois x s points, c features): rois 3 and 7
    empty (mask all False), roi 5 with 5 valid points."""
    r = np.random.RandomState(seed)
    xyz = r.uniform(-1, 1, (12, s, 3)).astype(np.float32)
    xyz[:, :s // 2] *= 0.3
    feats = r.randn(12, s, c).astype(np.float32)
    mask = np.ones((12, s), bool)
    mask[[3, 7]] = False
    mask[5, 5:] = False
    return xyz, feats, mask


@pytest.mark.parametrize('npoint', [8, None])
def test_set_abstraction_ssg(npoint):
    """A ball level (8 centres, radius 0.4, 8 samples) or the group-all
    level, MLP [16, 32]: centres, masks, features; empty rois give zeros
    and a False mask."""
    from glenet_tpu.models.point_rcnn_head import SetAbstractionSSG as J

    from glenet_tpu_torch.models.point_rcnn_head import SetAbstractionSSG
    xyz, feats, mask = _ssg_case(15)
    args = tuple(jnp.asarray(a) for a in (xyz, feats, mask))
    jmod = J(npoint=npoint, radius=0.4, nsample=8, mlp=(16, 32))
    with tp.pinned_f32():
        variables = _init(jmod, *args, seed=16)
        (nx, nf, nm), _ = _train(jmod, variables, *args)
        tmod = SetAbstractionSSG(6, npoint, 0.4, 8, (16, 32))
        load_jax_variables(tmod, variables)
        gx, gf, gm = tmod(*(_t(a) for a in (xyz, feats, mask)))
    assert (gx is None) == (nx is None) == (npoint is None)
    if gx is not None:
        np.testing.assert_array_equal(gx.numpy(), nx)
    np.testing.assert_array_equal(gm.numpy(), nm)
    assert not nm[[3, 7]].any() and not nf[[3, 7]].any()
    tp.assert_close(gf.detach(), nf)


def _head_cfg(dp_ratio):
    roi = copy.deepcopy(make_two_stage_cfg().MODEL.ROI_HEAD)
    roi.DP_RATIO = dp_ratio
    return roi


def _head_case(seed, n=12, s=32, c=16):
    """Canonical pooled rois [xyz, score, depth, features] (rois 2 and 9
    empty: zeros) and their empty flags."""
    r = np.random.RandomState(seed)
    pooled = np.concatenate([r.uniform(-1.5, 1.5, (n, s, 3)),
                             r.uniform(0, 1, (n, s, 1)),
                             r.uniform(-0.5, 0.5, (n, s, 1)),
                             r.randn(n, s, c)], -1).astype(np.float32)
    empty = np.zeros(n, bool)
    empty[[2, 9]] = True
    pooled[empty] = 0.0
    return pooled, empty


@pytest.mark.parametrize('train', [False, True])
def test_point_rcnn_head(train):
    """make_two_stage_cfg's PointRCNNHead (XYZ_UP_LAYER [16, 16], SA levels
    16 centres then group-all, FCs of 16) on 16-channel pooled features:
    rcnn_cls and rcnn_reg, in train mode with DP_RATIO 0.3 (JAX's dropout
    draws fed to the port) and every BN statistic."""
    import flax.linen as nn
    from glenet_tpu.models.point_rcnn_head import PointRCNNHead as J

    from glenet_tpu_torch.models.point_rcnn_head import PointRCNNHead
    roi = _head_cfg(0.3 if train else 0.0)
    pooled, empty = _head_case(17)
    jmod = J(model_cfg=roi, num_class=1, code_size=7)
    args = (jnp.asarray(pooled), jnp.asarray(empty))
    with tp.pinned_f32():
        shapes = jax.eval_shape(lambda: jmod.init(
            {'params': jax.random.PRNGKey(0),
             'dropout': jax.random.PRNGKey(1)}, *args, train=True))
        variables = tp.random_variables(shapes, seed=18)

        def run(v, *a):
            out, st = jmod.apply(
                v, *a, train=train, mutable=['batch_stats', 'intermediates'],
                capture_intermediates=lambda m, _: isinstance(m, nn.Dropout),
                rngs={'dropout': jax.random.PRNGKey(19)})
            return out, st

        want, state = jax.tree.map(np.asarray, jax.jit(run)(variables,
                                                           *args))
        tmod = PointRCNNHead(tp.to_port_cfg(roi), 16)
        load_jax_variables(tmod, variables)
        draws = (tp.jax_dropout_outputs({'roi_head': state['intermediates']})
                 if train else [])
        assert len(draws) == (2 if train else 0)
        with tp.fed_dropout(draws):
            got = tmod(_t(pooled), _t(empty), train=train)
    for k in ('rcnn_cls', 'rcnn_reg'):
        tp.assert_close(got[k].detach(), want[k], err_msg=k)
    if train:
        _assert_stats(tmod, state['batch_stats'])


def _cls_case(tcfg):
    """test_torch_targets' 'mixed' sampler case, the first seed whose
    IoUs lie MARGIN away from every threshold of `tcfg` and which has rois
    in the ignored band (CLS_BG_THRESH, CLS_FG_THRESH)."""
    from test_torch_targets import MARGIN, _draw_sample_case, _max_iou
    th = (tcfg.CLS_BG_THRESH_LO, tcfg.CLS_BG_THRESH, tcfg.REG_FG_THRESH,
          tcfg.CLS_FG_THRESH)
    for seed in range(200):
        case = _draw_sample_case('mixed', seed)
        iou = _max_iou(case[0], case[2], *case[3:5])
        band = (iou > th[1]) & (iou < th[3])
        if (band.any() and (iou > th[3]).any()
                and min(np.abs(iou - t).min() for t in th) > MARGIN):
            return case
    raise AssertionError('no case')


def test_cls_labels():
    """sample_rois_single with make_two_stage_cfg's TARGET_CONFIG
    (CLS_SCORE_TYPE cls, thresholds 0.6 / 0.45) on JAX's draws: the same
    rois, and hard labels with the ignored band at -1."""
    from glenet_tpu.models import roi_heads as jrh
    from test_torch_targets import _jax_draws

    from glenet_tpu_torch.models import roi_heads as trh
    jcfg = make_two_stage_cfg().MODEL.ROI_HEAD.TARGET_CONFIG
    tcfg = tp.to_port_cfg(make_two_stage_cfg()).MODEL.ROI_HEAD.TARGET_CONFIG
    rois, scores, labels, gt, mask, unc = _cls_case(tcfg)
    key = jax.random.PRNGKey(23)
    ref = jax.tree.map(np.asarray, jrh.sample_rois_single(
        key, rois, scores, labels, gt, mask, unc, cfg=jcfg))
    draws = [_t(d) for d in _jax_draws(key, len(rois), tcfg.ROI_PER_IMAGE)]
    got = trh.sample_rois_single(_t(rois), _t(scores), _t(labels), _t(gt),
                                 _t(mask), _t(unc), tcfg, *draws)
    np.testing.assert_array_equal(got['rois'].numpy(), ref['rois'])
    np.testing.assert_array_equal(got['rcnn_cls_labels'].numpy(),
                                  ref['rcnn_cls_labels'])
    assert set(ref['rcnn_cls_labels'].tolist()) == {-1.0, 0.0, 1.0}
