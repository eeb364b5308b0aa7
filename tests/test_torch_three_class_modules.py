"""The modules of KITTI's three-class detectors in the port against
glenet_tpu, numpy-drawn f32 inputs and weights on both sides:

  - ops/nms.multi_classes_nms: per-class greedy NMS merged by a stable
    descending sort, on scores with many exact zeros (invalid slots all
    score 0, so the merge sorts long runs of ties) and with repeated
    positive scores; nms_bev's lazy pass with few live candidates (the
    dense heads' final NMS at a published threshold);
  - AnchorHeadMulti (second_multihead.yaml's head): one head per class and
    Pedestrian with Cyclist in one head; eval and train forwards, BN
    running stats, gradients of every parameter;
  - SECONDHead (second_iou.yaml's RoI head) and its bilinear sampling:
    rois inside, across and outside the edge of the map at several
    headings (the clamp-to-edge weights of the unclamped corners); eval
    and train forwards, BN running stats, gradients;
  - PillarVFE + PointPillarScatter (pointpillar.yaml): empty, one-point,
    partly and completely full pillars and an invalid slot; features in
    eval and train mode, BN running stats over the valid points only,
    gradients, the canvas.

Tolerances: integers exactly; values rtol 1e-4 / atol 1e-5; gradients per
tensor max |diff| <= 2e-4 max |grad| + 1e-6."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from glenet_tpu.config import Cfg  # noqa: E402

from glenet_tpu_torch.utils.jax_weights import (jax_tree_to_port,  # noqa: E402
                                                load_jax_variables)


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, n, spread=6.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1.5, 0.5, n)
    b[:, 3:6] = rng.uniform([0.6, 0.5, 1.4], [4.6, 1.9, 1.9], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize('case', ['zero_ties', 'positive_ties'])
def test_multi_classes_nms(case):
    from glenet_tpu.ops import nms as jnms

    from glenet_tpu_torch.ops import nms as tnms
    rng = np.random.RandomState(3)
    n, c = 96, 3
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, (n, c)).astype(np.float32)
    if case == 'zero_ties':
        # most scores exactly 0: few live boxes per class, so most of the
        # 3 x 32 merged slots are empty zeros
        scores[rng.uniform(0, 1, (n, c)) < 0.8] = 0.0
    else:
        scores = np.round(scores * 4) / 4       # 5 distinct values
    ref = jnms.multi_classes_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                 0.1, num_class=c, pre_max=64, post_max=32,
                                 score_threshold=0.0)
    got = tnms.multi_classes_nms(_t(boxes), _t(scores), 0.1, num_class=c,
                                 pre_max=64, post_max=32,
                                 score_threshold=0.0)
    idx, valid, labels, kept = (np.asarray(r) for r in ref)
    assert valid.sum() > 5
    if case == 'zero_ties':
        assert (kept == 0).sum() > 10
    else:                                       # repeated kept scores
        assert len(np.unique(kept[valid])) < valid.sum()
    np.testing.assert_array_equal(got[0].numpy(), idx)
    np.testing.assert_array_equal(got[1].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy(), labels)
    tp.assert_close(got[3], kept)


@pytest.mark.parametrize('n_live', [0, 40, 300])
def test_nms_bev_few_live_candidates(n_live):
    """The lazy pass (pre_max 1024 > 512) when only the top `n_live` of
    1024 candidates score above the threshold (a published threshold on a
    dense head): it stops after the block holding the last live one, with
    glenet_tpu's keeps."""
    from glenet_tpu.ops import nms as jnms

    from glenet_tpu_torch.ops import nms as tnms
    rng = np.random.RandomState(5)
    boxes = _boxes(rng, 1200, spread=30.0)
    scores = rng.uniform(0, 0.1, 1200).astype(np.float32)
    scores[rng.choice(1200, n_live, replace=False)] = rng.uniform(
        0.2, 1, n_live)
    ref_idx, ref_valid = (np.asarray(r) for r in jnms.nms_bev(
        jnp.asarray(boxes), jnp.asarray(scores), 0.1, pre_max=1024,
        post_max=500, score_threshold=0.1))
    idx, valid = tnms.nms_bev(_t(boxes), _t(scores), 0.1, pre_max=1024,
                              post_max=500, score_threshold=0.1)
    assert ref_valid.any() == (n_live > 0)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(idx.numpy()[ref_valid], ref_idx[ref_valid])


def _init(module, *args, **kwargs):
    shapes = jax.eval_shape(
        lambda: module.init({'params': jax.random.PRNGKey(0),
                             'dropout': jax.random.PRNGKey(1)},
                            *args, **kwargs))
    return tp.random_variables(shapes, seed=5)


def _as_dict(out):
    return out if isinstance(out, dict) else {'out': out}


def _compare_module(jmod, tmod, jax_args, torch_args, loss_w):
    """Eval and train forwards (every output leaf; a lone output is
    'out'), BN running stats after the train forward, and the gradients of
    sum(out * w) over every parameter."""
    v = _init(jmod, *jax_args, train=True)
    load_jax_variables(tmod, v)
    with torch.no_grad():
        got = _as_dict(tmod(*torch_args(), train=False))
    ref = _as_dict(jmod.apply(v, *jax_args, train=False))
    for k, r in ref.items():
        if k != 'no_reg_loss':
            tp.assert_close(got[k], r, err_msg=f'eval {k}')

    def loss(params):
        out, state = jmod.apply({'params': params,
                                 'batch_stats': v['batch_stats']},
                                *jax_args, train=True,
                                mutable=['batch_stats'])
        out = _as_dict(out)
        return sum((out[k] * loss_w[k]).sum() for k in loss_w), (out, state)

    grads, (ref_out, state) = jax.grad(loss, has_aux=True)(v['params'])
    tmod.train()
    got = _as_dict(tmod(*torch_args(), train=True))
    for k in loss_w:
        tp.assert_close(got[k].detach(), ref_out[k], err_msg=f'train {k}')
    sum((got[k] * _t(loss_w[k])).sum() for k in loss_w).backward()
    buffers = dict(tmod.named_buffers())
    stats = jax_tree_to_port(tmod, state['batch_stats'], 'batch_stats')
    assert stats
    for k, r in stats.items():
        tp.assert_close(buffers[k], r, err_msg=k)
    ref_g = jax_tree_to_port(tmod, grads)
    params = dict(tmod.named_parameters())
    assert set(ref_g) == set(params)
    for k, g_ref in ref_g.items():
        g = params[k].grad.numpy()
        tol = 2e-4 * np.abs(g_ref).max() + 1e-6
        assert np.abs(g - g_ref).max() <= tol, (k, np.abs(g - g_ref).max())


@pytest.mark.parametrize('groups', [
    (('Car',), ('Pedestrian',), ('Cyclist',)),
    (('Car',), ('Pedestrian', 'Cyclist'))])
def test_anchor_head_multi(groups):
    from glenet_tpu.models import anchor_heads as jah

    from glenet_tpu_torch.models import anchor_heads as tah
    names = ('Car', 'Pedestrian', 'Cyclist')
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 5, 24).astype(np.float32)
    kw = dict(num_class=3, anchors_per_class=(2, 2, 2), head_groups=groups,
              code_size=7, num_dir_bins=2, shared_ch=16)
    jmod = jah.AnchorHeadMulti(class_names=names, **kw)
    tmod = tah.AnchorHeadMulti(24, class_names=names, **kw)
    w = {k: rng.randn(2, 6, 5, 6, c).astype(np.float32)
         for k, c in (('cls_preds', 3), ('box_preds', 7),
                      ('dir_cls_preds', 2))}
    _compare_module(jmod, tmod, (jnp.asarray(x),),
                    lambda: (_t(x),), w)
    with torch.no_grad():
        cls = tmod(_t(x))['cls_preds'].numpy()
    # the anchors of a head whose group lacks a class hold -20 there
    assert (cls[..., 0:2, 1:] == -20).all()
    assert (cls[..., 2:, 0] == -20).all()


def _second_head_case():
    """Rois over a 6 x 8 map of stride 8 x 0.05 m: inside, across each edge
    and outside it, at headings over the whole circle."""
    rng = np.random.RandomState(2)
    b, r, h, w, c = 2, 10, 6, 8, 12
    pc_range = (0.0, -1.2, -3.0, 3.2, 1.2, 1.0)
    rois = np.zeros((b, r, 7), np.float32)
    rois[..., 0] = rng.uniform(-0.6, 3.8, (b, r))     # map spans 0 .. 3.2 m
    rois[..., 1] = rng.uniform(-1.6, 1.6, (b, r))     # and -1.2 .. 1.2 m
    rois[..., 2] = -1.0
    rois[..., 3:6] = rng.uniform([0.4, 0.3, 1.4], [2.0, 0.9, 1.8], (b, r, 3))
    rois[..., 6] = np.linspace(-np.pi, np.pi, b * r).reshape(b, r)
    feat = rng.randn(b, h, w, c).astype(np.float32)
    cfg = Cfg({'SHARED_FC': [16, 16], 'IOU_FC': [16], 'DP_RATIO': 0.0,
               'ROI_GRID_POOL': {'GRID_SIZE': 3, 'IN_CHANNEL': c,
                                 'DOWNSAMPLE_RATIO': 8}})
    return rois, feat, cfg, (0.05, 0.05, 0.1), pc_range


def test_bilinear_interpolate_clamps_to_edge():
    from glenet_tpu.models.pfe import bilinear_interpolate as jbi

    from glenet_tpu_torch.models.roi_heads import bilinear_interpolate as tbi
    rng = np.random.RandomState(4)
    im = rng.randn(5, 7, 3).astype(np.float32)
    x = rng.uniform(-2.5, 9.5, 200).astype(np.float32)
    y = rng.uniform(-2.5, 7.5, 200).astype(np.float32)
    x[:4] = [0.0, 6.0, -1.0, 7.0]                     # on and past the edge
    ref = jbi(jnp.asarray(im), jnp.asarray(x), jnp.asarray(y))
    tp.assert_close(tbi(_t(im), _t(x), _t(y)), ref)


def test_second_head():
    from glenet_tpu.models.roi_heads import SECONDHead as JHead

    from glenet_tpu_torch.models.roi_heads import SECONDHead as THead
    rois, feat, cfg, voxel_size, pc_range = _second_head_case()
    jmod = JHead(model_cfg=cfg, voxel_size=voxel_size, pc_range=pc_range)
    tmod = THead(tp.to_port_cfg(cfg), voxel_size, pc_range, feat.shape[-1])
    outside = ((rois[..., 0] < 0) | (rois[..., 0] > 3.2)
               | (np.abs(rois[..., 1]) > 1.2))
    assert outside.any() and not outside.all()
    w = {'rcnn_cls': np.random.RandomState(6).randn(
        rois.shape[0] * rois.shape[1], 1).astype(np.float32)}
    _compare_module(jmod, tmod, (jnp.asarray(rois), jnp.asarray(feat)),
                    lambda: (_t(rois), _t(feat)), w)
    # the sampled features carry no gradient into the map
    tf = _t(feat).requires_grad_(True)
    tmod(_t(rois), tf, train=True)['rcnn_cls'].sum().backward()
    assert tf.grad is None


def _pillar_case():
    """5 pillar slots per sample of up to 6 points: full, partly full, one
    point, empty (a valid coordinate with no point cannot occur, so the
    empty slot is also the invalid one), and a second partly full."""
    rng = np.random.RandomState(7)
    b, v, p = 2, 5, 6
    voxel_size, pc_range = (0.5, 0.5, 4.0), (0.0, -2.0, -3.0, 4.0, 2.0, 1.0)
    counts = np.array([[6, 3, 1, 0, 4], [6, 6, 2, 0, 1]], np.int32)
    coords = np.zeros((b, v, 3), np.int32)
    voxels = np.zeros((b, v, p, 4), np.float32)
    for i in range(b):
        cells = rng.choice(8 * 8, v, replace=False)
        for j in range(v):
            y, x = divmod(int(cells[j]), 8)
            coords[i, j] = (0, y, x) if counts[i, j] else (-1, -1, -1)
            n = counts[i, j]
            voxels[i, j, :n, 0] = x * 0.5 + rng.uniform(0, 0.5, n)
            voxels[i, j, :n, 1] = -2.0 + y * 0.5 + rng.uniform(0, 0.5, n)
            voxels[i, j, :n, 2] = rng.uniform(-3, 1, n)
            voxels[i, j, :n, 3] = rng.uniform(0, 1, n)
    return voxels, counts, coords, counts > 0, voxel_size, pc_range


def test_pillar_vfe_and_scatter():
    """PillarVFE on the batch flattened into the pillar axis (BN moments
    over the valid points of both samples), then the canvas of each
    sample."""
    from glenet_tpu.models.map_to_bev import PointPillarScatter as JScatter
    from glenet_tpu.models.vfe import PillarVFE as JVFE

    from glenet_tpu_torch.models.map_to_bev import PointPillarScatter
    from glenet_tpu_torch.models.vfe import PillarVFE
    voxels, counts, coords, mask, voxel_size, pc_range = _pillar_case()
    b, v, p, _ = voxels.shape
    flat = (voxels.reshape(b * v, p, 4), counts.reshape(b * v),
            coords.reshape(b * v, 3))
    jmod = JVFE(num_filters=(8, 16), voxel_size=voxel_size,
                point_cloud_range=pc_range)
    tmod = PillarVFE(4, (8, 16), voxel_size, pc_range)
    w = np.random.RandomState(8).randn(b * v, 16).astype(np.float32)
    _compare_module(jmod, tmod, tuple(jnp.asarray(a) for a in flat),
                    lambda: tuple(_t(a) for a in flat), {'out': w})
    with torch.no_grad():
        feats = tmod(*(_t(a) for a in flat)).reshape(b, v, -1)
    assert not feats.numpy()[~mask].any() and feats.numpy()[mask].any()
    canvas = PointPillarScatter((8, 8, 1))(feats, _t(coords), _t(mask))
    ref = jax.vmap(lambda f, c, m: JScatter(grid_size=(8, 8, 1)).apply(
        {}, f, c, m))(jnp.asarray(feats.numpy()), jnp.asarray(coords),
                      jnp.asarray(mask))
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(ref))
    assert int((canvas.abs().sum(-1) > 0).sum()) == int(mask.sum())
