"""Parity of the single-stage pieces the port took from glenet_tpu last:
SE-SSD's od-IoU regression (utils/losses.odiou_3d_loss, anchor_heads.
reg_loss_odiou, DENSE_HEAD.NAME AnchorHeadSessd), the ATSS assigner
(target_assigner.atss_assign_targets) and MATCH_HEIGHT (3D IoU in the
axis-aligned assigner and in ATSS), each against glenet_tpu on the CPU,
f32 on both sides.

Tolerances: integer targets exactly; od-IoU losses rtol 1e-5 and their
gradients per tensor within 1e-5 of the largest |gradient| (+1e-7); box
targets and label variances rtol 1e-4 / atol 1e-5; the toy train steps as
tests/test_torch_glenet_s.py (loss terms rtol 1e-4, gradients 2e-4 of the
largest |gradient| + 1e-6, BN stats rtol 1e-4).

The od-IoU gradient flows through the polygon clipping of
ops/iou3d.overlap_bev_corners, which sorts the candidate vertices by angle.
Where two boxes coincide, or a corner of one lies on an edge of the other,
two candidates sit at one angle and the packages may order them apart:
the clipped area is the same, but its gradient is then a choice between
one-sided derivatives.  The gradient test draws its pairs off those sets
(centre offsets of at least 1 cm, heading differences of at least 0.01
rad); coincident pairs are held by value only."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402


def _pairs(seed, n=48):
    """n row-aligned (gt, pred) box pairs that overlap, off coincidence;
    a few with non-positive sizes (counted 0)."""
    rng = np.random.RandomState(seed)
    g = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                  rng.uniform(-1, 1, n), rng.uniform(3, 5, n),
                  rng.uniform(1.5, 2, n), rng.uniform(1.4, 1.8, n),
                  rng.uniform(-np.pi, np.pi, n)], 1)
    off = rng.uniform(0.01, 0.8, (n, 3)) * rng.choice([-1, 1], (n, 3))
    q = g.copy()
    q[:, :3] += off
    q[:, 3:6] *= rng.uniform(0.8, 1.2, (n, 3))
    q[:, 6] += rng.uniform(0.01, 0.5, n) * rng.choice([-1, 1], n)
    q[:4, 3] = [-1.0, 0.0, 2.0, 3.0]             # non-positive sizes
    q[2:4, 5] = [0.0, -0.5]
    w = rng.uniform(0, 1, n)
    return g.astype(np.float32), q.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1])
def test_odiou_loss_and_gradient(seed):
    from glenet_tpu.utils import losses as jl

    from glenet_tpu_torch.utils import losses
    g, q, w = _pairs(seed)
    ref, (rg, rq) = jax.value_and_grad(
        lambda a, b: jl.odiou_3d_loss(a, b, jnp.asarray(w), 2),
        argnums=(0, 1))(jnp.asarray(g), jnp.asarray(q))
    tg, tq = (torch.from_numpy(x).requires_grad_() for x in (g, q))
    got = losses.odiou_3d_loss(tg, tq, torch.from_numpy(w), 2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    for a, b in ((tg.grad, rg), (tq.grad, rq)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max() + 1e-7


def test_odiou_coincident_boxes_value():
    """Identical boxes: od-IoU 1 - 1 + 0 + 0 per pair, by value."""
    from glenet_tpu.utils import losses as jl

    from glenet_tpu_torch.utils import losses
    g, _, w = _pairs(3, n=8)
    ref = float(jl.odiou_3d_loss(jnp.asarray(g), jnp.asarray(g),
                                 jnp.asarray(w), 1))
    got = float(losses.odiou_3d_loss(torch.from_numpy(g),
                                     torch.from_numpy(g),
                                     torch.from_numpy(w), 1))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert abs(got) < 1e-4


def test_reg_loss_odiou():
    """On decoded anchors: the loss, and its gradient to the box
    predictions (the decoded targets carry none)."""
    from glenet_tpu.models import anchor_heads as jah
    from glenet_tpu.utils import box_coder as jbc

    from glenet_tpu_torch.models import anchor_heads
    from glenet_tpu_torch.utils import box_coder
    rng = np.random.RandomState(5)
    b, n = 2, 64
    anchors = np.stack([rng.uniform(0, 16, n), rng.uniform(-8, 8, n),
                        np.full(n, -1.0), np.full(n, 3.9), np.full(n, 1.6),
                        np.full(n, 1.56), rng.choice([0, 1.57], n)],
                       1).astype(np.float32)
    preds = (rng.randn(b, n, 7) * 0.2).astype(np.float32)
    targets = (rng.randn(b, n, 7) * 0.2).astype(np.float32)
    labels = rng.choice([-1, 0, 1], (b, n), p=[0.2, 0.5, 0.3]).astype(
        np.int32)
    ref, rgrad = jax.value_and_grad(lambda p: jah.reg_loss_odiou(
        p, jnp.asarray(targets), jnp.asarray(labels), jnp.asarray(anchors),
        jbc.ResidualCoder()))(jnp.asarray(preds))
    tp_ = torch.from_numpy(preds).requires_grad_()
    got = anchor_heads.reg_loss_odiou(
        tp_, torch.from_numpy(targets), torch.from_numpy(labels),
        torch.from_numpy(anchors), box_coder.ResidualCoder())
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    rgrad = np.asarray(rgrad)
    assert np.abs(tp_.grad.numpy() - rgrad).max() <= \
        1e-5 * np.abs(rgrad).max() + 1e-7


def _cfg(kind):
    """The toy single-stage topology (torch_parity's 3-class SECOND toy)
    as SE-SSD's head with the axis-aligned assigner ('sessd'), with ATSS
    ('atss'), with MATCH_HEIGHT ('match_height'), or all three
    ('sessd_atss_height')."""
    cfg = tp.tiny_single_stage_cfg('SECOND')
    head = cfg.MODEL.DENSE_HEAD
    ta = head.TARGET_ASSIGNER_CONFIG
    if 'sessd' in kind:
        head.NAME = 'AnchorHeadSessd'
    if 'atss' in kind:
        ta.NAME = 'ATSSTargetAssigner'
        ta.TOPK = 9
    if 'height' in kind:
        ta.MATCH_HEIGHT = True
    return cfg


def _tie_batch(cfg, seed=0):
    """single_stage_batch's gts, plus (in each sample) one Car gt exactly
    on an anchor centre (its 2 rotations tie in distance, and so do
    neighbours at the TOPK boundary) and a second Car gt 0.05 m off the
    same centre with the same size (both gts' best anchor is one anchor:
    the later gt takes it)."""
    from glenet_tpu.models.anchors import generate_anchors
    from glenet_tpu.ops.voxelize import compute_grid_size
    batch = tp.single_stage_batch(cfg, seed=3 + seed)
    vox = cfg.DATA_CONFIG.DATA_PROCESSOR[0]
    a = np.asarray(generate_anchors(
        cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG,
        compute_grid_size(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, vox.VOXEL_SIZE),
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE).anchors)
    for b in range(batch['gt_boxes'].shape[0]):
        c = a[1 + b, 1, 0]                           # a Car anchor
        batch['gt_boxes'][b, 3] = [*c[:6], 0.0, 1]
        batch['gt_boxes'][b, 4] = [c[0] + 0.05, *c[1:6], 0.0, 1]
        batch['gt_mask'][b, 3:5] = True
    return batch


def _atss_margin(det, batch, margin=1e-5):
    """No ATSS candidate IoU lies within `margin` of its gt's threshold."""
    from glenet_tpu.ops import iou3d
    anchors = jnp.asarray(det.anchor_set.flat_anchors)
    for b in range(batch['gt_boxes'].shape[0]):
        gt = jnp.asarray(batch['gt_boxes'][b][batch['gt_mask'][b], :7])
        fn = iou3d.boxes_iou3d if det.match_height \
            else iou3d.boxes_iou_bev_blocked
        iou = np.asarray(fn(anchors, gt)).T
        d = np.linalg.norm(np.asarray(anchors)[None, :, :3]
                           - np.asarray(gt)[:, None, :3], axis=-1)
        idx = np.argsort(d, axis=1, kind='stable')[:, :det.atss_topk]
        cand = np.take_along_axis(iou, idx, 1)
        k = cand.shape[1]
        thr = cand.mean(1) + np.sqrt(((cand - cand.mean(1)[:, None]) ** 2)
                                     .sum(1) / (k - 1)) + 1e-6
        assert np.abs(cand - thr[:, None]).min() > margin


@pytest.mark.parametrize('kind', ['atss', 'match_height',
                                  'sessd_atss_height'])
def test_targets(kind):
    """Anchor targets of glenet_tpu's Detector and of the port's on the
    tie batch: labels exactly (positives in each class), box targets and
    label variances rtol 1e-4 / atol 1e-5."""
    from glenet_tpu.models.detectors import build_detector as jbuild

    from glenet_tpu_torch.models.detectors import build_detector
    cfg = _cfg(kind)
    det = jbuild(cfg)
    batch = _tie_batch(cfg)
    if 'atss' in kind:
        _atss_margin(det, batch)
    else:
        tp.assert_assigner_margin(det, batch)
    tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
    for b in range(batch['gt_boxes'].shape[0]):
        args = [batch[k][b] for k in ('gt_boxes', 'gt_mask',
                                      'gt_uncertainty')]
        ref = tp.jax_assign_targets(det, *map(jnp.asarray, args))
        got = tdet.assign_targets(*map(torch.from_numpy, args))
        np.testing.assert_array_equal(got.box_cls_labels.numpy(),
                                      np.asarray(ref.box_cls_labels))
        assert set(np.unique(got.box_cls_labels.numpy())) >= {1, 2, 3}
        for f in ('box_reg_targets', 'reg_weights', 'label_uncertainty'):
            tp.assert_close(getattr(got, f), getattr(ref, f), err_msg=f)


def test_atss_force_match_later_gt_wins():
    """Two gts whose best anchor is the same: the later one takes it."""
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = _cfg('atss')
    batch = _tie_batch(cfg)
    tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
    gb = torch.from_numpy(batch['gt_boxes'][0])
    gm = torch.from_numpy(batch['gt_mask'][0])
    gu = torch.from_numpy(batch['gt_uncertainty'][0])
    t = tdet.assign_targets(gb, gm, gu)
    from glenet_tpu_torch.ops import iou3d
    iou = iou3d.boxes_iou_bev(torch.from_numpy(
        tdet.anchor_set.flat_anchors), gb[:, :7])
    a3, a4 = int(iou[:, 3].argmax()), int(iou[:, 4].argmax())
    assert a3 == a4
    torch.testing.assert_close(t.label_uncertainty[a3], gu[4])


@pytest.fixture(scope='module', params=['sessd', 'atss', 'match_height'])
def step(request):
    cfg = _cfg(request.param)
    batch = tp.single_stage_batch(cfg)
    with tp.pinned_f32():
        return cfg, tp.run_single_stage_step(cfg, batch)


def test_train_step(step):
    """One toy train step of each config: targets, every loss term
    (od-IoU's loss_loc for SE-SSD's head), every gradient, BN stats."""
    cfg, (ref, metrics, grads, targets, tdet) = step
    tp.assert_single_stage_targets((ref, metrics, grads, targets, tdet))
    tp.assert_loss_terms_equal(metrics, ref['metrics'])
    tp.assert_grads_equal(grads, ref['grads'], tdet)
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])
    assert tdet.use_odiou == (cfg.MODEL.DENSE_HEAD.NAME == 'AnchorHeadSessd')
