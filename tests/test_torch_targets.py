"""The port's anchor target assigner, RoI target sampler, canonical RoI
frame and RCNN losses (glenet_tpu_torch/models/{target_assigner,roi_heads}
.py) against glenet_tpu, numpy-drawn f32 inputs on both sides.

Integer outputs (anchor labels, the sampled RoI indices, masks) must be
equal.  The sampler gets the JAX package's own random draws, rebuilt from
the key as sample_rois_single draws them.  Every case is checked to keep
its IoUs more than 1e-4 away from the thresholds they are compared with,
so f32 rounding in another order cannot move a RoI or an anchor across one.
Tolerances: box targets atol 1e-5; the sampled RoIs' 3D IoUs atol 1e-4
(rotated polygon clipping of two implementations in f32 on coordinates of
up to 60 m; 3.3e-5 seen) and their soft labels atol 2e-4 (that difference
scaled by 1 / (CLS_FG - CLS_BG) = 2); losses rtol 1e-5, their gradients
rtol 1e-4 / atol 1e-7."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from glenet_tpu.models import anchors as janc  # noqa: E402
from glenet_tpu.models import roi_heads as jrh  # noqa: E402
from glenet_tpu.models import target_assigner as jta  # noqa: E402
from glenet_tpu.ops import iou3d as jiou  # noqa: E402
from glenet_tpu.utils import box_coder as jbc  # noqa: E402
from glenet_tpu.utils import box_utils as jbu  # noqa: E402

from glenet_tpu_torch.models import anchors as tanc  # noqa: E402
from glenet_tpu_torch.models import roi_heads as trh  # noqa: E402
from glenet_tpu_torch.models import target_assigner as tta  # noqa: E402
from glenet_tpu_torch.utils import box_coder as tbc  # noqa: E402

MARGIN = 1e-4
GRID, PC_RANGE = (128, 128, 24), (0.0, -32.0, -3.0, 64.0, 32.0, 1.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs():
    cfg = tp.tiny_twostage_cfg()
    return (cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG,
            tp.to_port_cfg(cfg).MODEL.ROI_HEAD.TARGET_CONFIG)


# ---------------------------------------------------------------------------
# anchor target assignment
# ---------------------------------------------------------------------------

def _assign_case(seed, anchors_flat):
    """Gts near anchors: perturbed copies (positives), a far-off small one
    (force-matched below the threshold), a duplicate pair with different
    variances (first match wins), a masked slot and a gt of class 2."""
    rng = np.random.RandomState(seed)
    m = 10
    gt = np.zeros((m, 8), np.float32)
    pick = rng.choice(len(anchors_flat), 5, replace=False)
    gt[:5, :7] = anchors_flat[pick]
    gt[:5, :2] += rng.uniform(-0.6, 0.6, (5, 2))
    gt[:5, 3:6] *= rng.uniform(0.85, 1.15, (5, 3))
    gt[:5, 6] += rng.uniform(-0.3, 0.3, 5)
    gt[5, :7] = anchors_flat[pick[0]] + [1.7, 0.9, 0, 0, 0, 0, 0.5]
    gt[5, 3:6] *= 0.6                               # weak, force-matched
    gt[6] = gt[2]                                   # duplicate of gt 2
    gt[7, :7] = anchors_flat[pick[3]]
    gt[8, :7] = anchors_flat[pick[4]]
    gt[:9, 7] = 1
    gt[7, 7] = 2                                    # another class
    mask = np.ones(m, bool)
    mask[8] = False                                 # an empty slot
    unc = rng.uniform(0.01, 0.3, (m, 7)).astype(np.float32)
    return gt, mask, unc


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_assign_targets(seed):
    gen_cfg, _ = _cfgs()
    aset_j = janc.generate_anchors(gen_cfg, GRID, PC_RANGE)
    aset_t = tanc.generate_anchors(gen_cfg, GRID, PC_RANGE)
    np.testing.assert_array_equal(aset_t.flat_anchors, aset_j.flat_anchors)
    gt, mask, unc = _assign_case(seed, aset_j.flat_anchors)
    iou = np.asarray(jbu.boxes3d_nearest_bev_iou(
        aset_j.flat_anchors, gt[mask & (gt[:, 7] == 1), :7]))
    for thr in (0.6, 0.45):
        assert np.abs(iou - thr).min() > MARGIN, 'an IoU near a threshold'
    ref = jta.assign_targets(aset_j, gt, mask, unc, jbc.ResidualCoder())
    got = tta.assign_targets(aset_t, _t(gt), _t(mask), _t(unc),
                             tbc.ResidualCoder())
    labels = np.asarray(ref.box_cls_labels)
    assert (labels > 0).sum() >= 5 and (labels == 0).any()
    np.testing.assert_array_equal(got.box_cls_labels.numpy(), labels)
    np.testing.assert_array_equal(got.reg_weights.numpy(),
                                  np.asarray(ref.reg_weights))
    np.testing.assert_allclose(got.box_reg_targets.numpy(),
                               np.asarray(ref.box_reg_targets), atol=1e-5)
    np.testing.assert_array_equal(got.label_uncertainty.numpy(),
                                  np.asarray(ref.label_uncertainty))
    # the duplicate pair: its anchors carry the first gt's variances
    best = np.argmax(iou[:, 2])
    np.testing.assert_array_equal(got.label_uncertainty[best].numpy(),
                                  unc[2])


# ---------------------------------------------------------------------------
# RoI target sampling
# ---------------------------------------------------------------------------

def _draw_sample_case(kind, seed):
    rng = np.random.RandomState(seed)
    n, m = 64, 8
    gt = np.zeros((m, 8), np.float32)
    gt[:6, :2] = rng.uniform([2, -20], [60, 20], (6, 2))
    gt[:6, 2] = -0.8
    gt[:6, 3:6] = [3.9, 1.6, 1.56]
    gt[:6, 6] = rng.uniform(-np.pi, np.pi, 6)
    gt[:6, 7] = 1
    gt[5, 7] = 2
    mask = np.arange(m) < 6
    jitter = {'mixed': 1.0, 'many_fg': 0.25, 'no_fg': 3.0,
              'no_easy': 0.0}[kind]
    owner = rng.randint(0, 6, n)
    rois = gt[owner, :7].copy()
    rois[:, :2] += rng.randn(n, 2) * jitter
    rois[:, 6] += rng.randn(n) * 0.2 * jitter
    labels = gt[owner, 7].astype(np.int32)
    if kind == 'mixed':
        rois[-16:, :2] = rng.uniform([2, -20], [60, 20], (16, 2))
        labels = np.where(rng.rand(n) < 0.1, 2, 1).astype(np.int32)
    if kind == 'no_easy':
        # shifted along the heading: BEV IoU (3.9 - d) / (3.9 + d)
        d = rng.uniform(0.5, 3.0, n) * np.sign(rng.randn(n))
        rois[:, 0] += d * np.cos(rois[:, 6])
        rois[:, 1] += d * np.sin(rois[:, 6])
    return (rois.astype(np.float32), rng.rand(n).astype(np.float32), labels,
            gt, mask, rng.uniform(0.01, 0.3, (m, 7)).astype(np.float32))


def _max_iou(rois, labels, gt, mask):
    iou = np.asarray(jiou.boxes_iou3d(rois, gt[:, :7]))
    same = (labels[:, None] == gt[None, :, 7]) & mask[None]
    return np.clip(np.where(same, iou, -1).max(1), 0, None)


def _sample_case(kind):
    """rois (64, 7) around 8 gt slots, the first seed whose case has the
    pools `kind` names and keeps every IoU MARGIN away from the sampler's
    thresholds.  Returns rois, roi_scores, roi_labels, gt_boxes, gt_mask,
    gt_unc."""
    for seed in range(100):
        case = _draw_sample_case(kind, seed)
        max_iou = _max_iou(*case[:1], case[2], *case[3:5])
        fg, easy = max_iou >= 0.55, max_iou < 0.1
        pools = {'mixed': fg.any() and easy.any() and (~fg & ~easy).any(),
                 'many_fg': fg.sum() > 16, 'no_fg': not fg.any(),
                 'no_easy': not easy.any()}[kind]
        margin = min(np.abs(max_iou - t).min() for t in (0.1, 0.25, 0.55,
                                                         0.75))
        if pools and margin > MARGIN:
            return case
    raise AssertionError(f'no {kind} case')


def _jax_draws(key, n, r):
    k_fg, k_hard, k_easy = jax.random.split(key, 3)
    return (jax.random.uniform(k_fg, (n,)),
            jax.random.randint(k_hard, (r,), 0, 1_000_000),
            jax.random.randint(k_easy, (r,), 0, 1_000_000))


@pytest.mark.parametrize('kind', ['mixed', 'many_fg', 'no_fg', 'no_easy'])
def test_sample_rois_single(kind):
    _, tcfg = _cfgs()
    rois, scores, labels, gt, mask, unc = _sample_case(kind)

    key = jax.random.PRNGKey(11)
    ref = jrh.sample_rois_single(key, rois, scores, labels, gt, mask, unc,
                                 cfg=tcfg)
    draws = [_t(d) for d in _jax_draws(key, len(rois), tcfg.ROI_PER_IMAGE)]
    got = trh.sample_rois_single(_t(rois), _t(scores), _t(labels), _t(gt),
                                 _t(mask), _t(unc), tcfg, *draws)
    # the sampled indices: rois are distinct rows of the input
    idx_ref = [int(np.flatnonzero((rois == r).all(1))[0])
               for r in np.asarray(ref['rois'])]
    idx_got = [int(np.flatnonzero((rois == r).all(1))[0])
               for r in got['rois'].numpy()]
    assert idx_got == idx_ref
    for k in ('gt_of_rois_src', 'roi_labels', 'roi_scores', 'gt_unc_of_rois',
              'reg_valid_mask'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got['roi_ious'].numpy(),
                               np.asarray(ref['roi_ious']), atol=1e-4)
    np.testing.assert_allclose(got['rcnn_cls_labels'].numpy(),
                               np.asarray(ref['rcnn_cls_labels']), atol=2e-4)
    ct_ref = jrh.canonical_gt_of_rois(ref['rois'], ref['gt_of_rois_src'])
    ct = trh.canonical_gt_of_rois(got['rois'], got['gt_of_rois_src'])
    np.testing.assert_allclose(ct.numpy(), np.asarray(ct_ref), atol=1e-5)


def test_roi_sampling_draws():
    """The draws of one sample: shapes, ranges, and one generator state
    giving one set of draws."""
    gen = torch.Generator().manual_seed(5)
    u, rh, re = trh.draw_roi_sampling(100, 32, gen)
    assert u.shape == (100,) and rh.shape == re.shape == (32,)
    assert 0 <= float(u.min()) and float(u.max()) < 1
    assert 0 <= int(rh.min()) and int(rh.max()) < trh.RANDINT_HIGH
    again = trh.draw_roi_sampling(100, 32, torch.Generator().manual_seed(5))
    for a, b in zip((u, rh, re), again):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# RCNN losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('fg_share', [0.6, 0.0])
def test_rcnn_losses(fg_share):
    """The KL-label regression terms and the corner loss, with foreground
    RoIs and with none (the fg count clamped to 1, every term 0)."""
    rng = np.random.RandomState(8)
    b, r = 2, 16
    rois = np.stack([_draw_sample_case('mixed', s)[0][:r] for s in (1, 2)])
    gt_src = rois.copy()
    gt_src[..., :3] += rng.randn(b, r, 3).astype(np.float32) * 0.3
    gt_src[..., 6] += rng.randn(b, r).astype(np.float32) * 0.2
    gt_src = np.concatenate([gt_src, np.ones((b, r, 1), np.float32)], -1)
    ct = np.stack([np.asarray(jrh.canonical_gt_of_rois(rois[i], gt_src[i]))
                   for i in range(b)])
    unc = rng.uniform(0.01, 0.3, (b, r, 7)).astype(np.float32)
    valid = (rng.rand(b, r) < fg_share).astype(np.int32)
    cls_labels = np.where(rng.rand(b * r) < 0.2, -1.0,
                          rng.rand(b * r)).astype(np.float32)
    reg = (rng.randn(b * r, 7) * 0.2).astype(np.float32)
    std = (rng.randn(b * r, 7) * 0.5).astype(np.float32)
    cls = rng.randn(b * r, 1).astype(np.float32)
    lw = {'rcnn_reg_weight': 1.5}
    cw = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0]

    rois, ct, gt_src, unc = (jnp.asarray(a) for a in (rois, ct, gt_src, unc))

    def jax_loss(cls_, reg_, std_):
        c = jrh.rcnn_cls_loss(cls_, cls_labels)
        rl, parts = jrh.rcnn_reg_loss(
            reg_, std_, rois, ct, gt_src, unc, valid, jbc.ResidualCoder(),
            lw, corner_weight=0.7, code_weights=cw)
        return c + rl, {'cls': c, **parts}

    def torch_loss(cls_, reg_, std_):
        c = trh.rcnn_cls_loss(cls_, _t(cls_labels))
        rl, parts = trh.rcnn_reg_loss(
            reg_, std_, _t(rois), _t(ct), _t(gt_src), _t(unc), _t(valid),
            tbc.ResidualCoder(), lw, corner_weight=0.7, code_weights=cw)
        return c + rl, {'cls': c, **parts}

    (total_j, parts_j), grads_j = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(std))
    ins = [_t(a).requires_grad_(True) for a in (cls, reg, std)]
    total_t, parts_t = torch_loss(*ins)
    total_t.backward()
    assert set(parts_t) == set(parts_j)
    np.testing.assert_allclose(float(total_t.detach()), float(total_j),
                               rtol=1e-5)
    for k, v in parts_j.items():
        np.testing.assert_allclose(float(parts_t[k].detach()), float(v),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for t, g in zip(ins, grads_j):
        grad = np.zeros(t.shape, np.float32) if t.grad is None else t.grad
        np.testing.assert_allclose(np.asarray(grad), np.asarray(g),
                                   rtol=1e-4, atol=1e-7)
