"""The port's loss functions, box coder encode, axis-aligned BEV IoU, 3D IoU
and the anchor-head losses (glenet_tpu_torch/utils/{losses,box_coder,
box_utils}.py, ops/iou3d.py, models/anchor_heads.py) against glenet_tpu,
values and gradients, numpy-drawn f32 inputs on both sides.

Tolerances: elementwise values rtol 1e-5 / atol 1e-6 (the same f32 formula,
transcendental functions of two libraries); reductions over many anchors
rtol 1e-5; gradients rtol 1e-4 / atol 1e-6; 3D IoU atol 1e-5 (rotated
polygon clipping in f32); integer direction targets exactly."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from glenet_tpu.models import anchor_heads as jah  # noqa: E402
from glenet_tpu.ops import iou3d as jiou  # noqa: E402
from glenet_tpu.utils import box_coder as jbc  # noqa: E402
from glenet_tpu.utils import box_utils as jbu  # noqa: E402
from glenet_tpu.utils import losses as jl  # noqa: E402

from glenet_tpu_torch.models import anchor_heads as tah  # noqa: E402
from glenet_tpu_torch.ops import iou3d as tiou  # noqa: E402
from glenet_tpu_torch.utils import box_coder as tbc  # noqa: E402
from glenet_tpu_torch.utils import box_utils as tbu  # noqa: E402
from glenet_tpu_torch.utils import losses as tl  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _boxes(rng, n, spread=6.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1.5, 0.5, n)
    b[:, 3:6] = rng.uniform([3.2, 1.4, 1.3], [4.6, 1.9, 1.8], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _grads(jax_fn, torch_fn, *arrays):
    """Gradients of sum(fn(*arrays)) w.r.t. every array, both packages."""
    ref = jax.grad(lambda *a: jnp.sum(jax_fn(*a)),
                   argnums=tuple(range(len(arrays))))(*arrays)
    ts = [_t(a).requires_grad_(True) for a in arrays]
    torch_fn(*ts).sum().backward()
    return [t.grad for t in ts], ref


def test_bce_and_focal():
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 50, 3) * 4).astype(np.float32)
    targets = (rng.rand(2, 50, 3) > 0.7).astype(np.float32)
    _close(tl.sigmoid_bce_with_logits(_t(logits), _t(targets)),
           jl.sigmoid_bce_with_logits(logits, targets))
    for w in (rng.rand(2, 50).astype(np.float32),
              rng.rand(2, 50, 3).astype(np.float32)):
        _close(tl.sigmoid_focal_loss(_t(logits), _t(targets), _t(w)),
               jl.sigmoid_focal_loss(logits, targets, w))
    got, ref = _grads(lambda x: jl.sigmoid_focal_loss(x, targets, w),
                      lambda x: tl.sigmoid_focal_loss(x, _t(targets), _t(w)),
                      logits)
    _close(got[0], ref[0], rtol=1e-4)


@pytest.mark.parametrize('beta', [1.0 / 9.0, 1.0, 0.0])
def test_smooth_l1(beta):
    diff = np.linspace(-2, 2, 101, dtype=np.float32)
    _close(tl.smooth_l1(_t(diff), beta), jl.smooth_l1(diff, beta))


def test_weighted_smooth_l1_nan_rule():
    """NaN targets count as a zero residual, with code and anchor weights;
    the gradient there is zero on both sides."""
    rng = np.random.RandomState(1)
    preds = rng.randn(2, 40, 7).astype(np.float32)
    targets = rng.randn(2, 40, 7).astype(np.float32)
    targets[0, :5, 2] = np.nan
    targets[1, 7] = np.nan
    w = rng.rand(2, 40).astype(np.float32)
    cw = [1.0, 1.0, 2.0, 1.0, 0.5, 1.0, 1.0]
    ref = jl.weighted_smooth_l1(preds, targets, w, code_weights=cw)
    got = tl.weighted_smooth_l1(_t(preds), _t(targets), _t(w),
                                code_weights=cw)
    _close(got, ref)
    assert (np.asarray(got)[0, :5, 2] == 0).all()
    got_g, ref_g = _grads(
        lambda p: jl.weighted_smooth_l1(p, targets, w, code_weights=cw),
        lambda p: tl.weighted_smooth_l1(p, _t(targets), _t(w),
                                        code_weights=cw), preds)
    _close(got_g[0], ref_g[0], rtol=1e-4)
    assert (got_g[0][1, 7] == 0).all()


def test_cross_entropy_sin_difference_corner_loss():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 30, 2).astype(np.float32)
    one_hot = np.eye(2, dtype=np.float32)[rng.randint(0, 2, (2, 30))]
    w = rng.rand(2, 30).astype(np.float32)
    _close(tl.weighted_cross_entropy(_t(logits), _t(one_hot), _t(w)),
           jl.weighted_cross_entropy(logits, one_hot, w))
    a, b = rng.randn(2, 30, 7).astype(np.float32), rng.randn(2, 30, 7).astype(
        np.float32)
    for got, ref in zip(tl.add_sin_difference(_t(a), _t(b)),
                        jl.add_sin_difference(a, b)):
        _close(got, ref)
    pred, gt = _boxes(rng, 25), jnp.asarray(_boxes(rng, 25))
    pred[:10] = gt[:10] + rng.randn(10, 7).astype(np.float32) * 0.2
    pred[5:10, 6] = gt[5:10, 6] + np.pi             # the flip branch
    pred = jnp.asarray(pred)
    mask = (rng.rand(25) > 0.3).astype(np.float32)
    _close(tl.corner_loss_lidar(_t(pred), _t(gt), _t(mask)),
           jl.corner_loss_lidar(pred, gt, mask), rtol=1e-5, atol=1e-5)
    got_g, ref_g = _grads(lambda p: jl.corner_loss_lidar(p, gt),
                          lambda p: tl.corner_loss_lidar(p, _t(gt)), pred)
    _close(got_g[0], ref_g[0], rtol=1e-4, atol=1e-5)


def test_box_coder_encode():
    rng = np.random.RandomState(3)
    anchors, boxes = _boxes(rng, 60), _boxes(rng, 60)
    boxes[:3, 3:6] = 0.0                       # the 1e-5 size clamp
    ref = jbc.ResidualCoder().encode(boxes, anchors)
    got = tbc.ResidualCoder().encode(_t(boxes), _t(anchors))
    _close(got, ref)
    _close(tbc.ResidualCoder().decode(got, _t(anchors))[3:],
           boxes[3:], rtol=1e-5, atol=1e-5)


def test_axis_aligned_bev_iou():
    rng = np.random.RandomState(4)
    a, b = _boxes(rng, 30, 4.0), _boxes(rng, 20, 4.0)
    a[:4, 6] = [np.pi / 4 - 1e-3, np.pi / 4 + 1e-3, np.pi / 2, -np.pi]
    _close(tbu.boxes3d_lidar_to_aligned_bev_boxes(_t(a)),
           jbu.boxes3d_lidar_to_aligned_bev_boxes(a))
    _close(tbu.boxes3d_nearest_bev_iou(_t(a), _t(b)),
           jbu.boxes3d_nearest_bev_iou(a, b))
    bev_a = jbu.boxes3d_lidar_to_aligned_bev_boxes(a)
    bev_b = jbu.boxes3d_lidar_to_aligned_bev_boxes(b)
    _close(tbu.boxes_iou_normal(_t(np.asarray(bev_a)), _t(np.asarray(bev_b))),
           jbu.boxes_iou_normal(bev_a, bev_b))


def test_boxes_iou3d():
    rng = np.random.RandomState(5)
    a, b = _boxes(rng, 24, 3.0), _boxes(rng, 16, 3.0)
    b[:4] = a[:4]                                    # identical boxes
    b[4:8] = a[4:8] + [0.3, -0.2, 0.1, 0, 0, 0, 0.2]  # partial overlaps
    ref = np.asarray(jiou.boxes_iou3d(a, b))
    got = tiou.boxes_iou3d(_t(a), _t(b))
    assert ref.max() > 0.99 and ((ref > 0.1) & (ref < 0.9)).any()
    _close(got, ref, rtol=0, atol=1e-5)


def _anchor_case(seed):
    rng = np.random.RandomState(seed)
    b, n = 2, 200
    anchors = _boxes(rng, n)
    labels = rng.choice([-1, 0, 1], size=(b, n), p=[0.2, 0.6, 0.2])
    labels[1] = np.where(labels[1] > 0, 0, labels[1])     # no positives
    return (rng.randn(b, n, 1).astype(np.float32) * 2,
            rng.randn(b, n, 7).astype(np.float32) * 0.5,
            rng.randn(b, n, 2).astype(np.float32),
            (rng.randn(b, n, 7) * 0.3).astype(np.float32),
            labels.astype(np.int32), anchors)


def test_anchor_head_losses():
    cls_p, box_p, dir_p, reg_t, labels, anchors = _anchor_case(6)
    anc = np.broadcast_to(anchors[None], (2, *anchors.shape)).copy()
    dir_j = np.asarray(jah.get_direction_targets(anc, reg_t, 0.78539, 2))
    dir_t = tah.get_direction_targets(_t(anc), _t(reg_t), 0.78539, 2)
    np.testing.assert_array_equal(dir_t.numpy(), dir_j)
    cw = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0]
    cases = [
        (lambda x: jah.cls_loss(x, labels, 1),
         lambda x: tah.cls_loss(x, _t(labels), 1), cls_p),
        (lambda x: jah.reg_loss_smooth_l1(x, reg_t, labels, code_weights=cw),
         lambda x: tah.reg_loss_smooth_l1(x, _t(reg_t), _t(labels),
                                          code_weights=cw), box_p),
        (lambda x: jah.dir_loss(x, dir_j, labels > 0, 2),
         lambda x: tah.dir_loss(x, dir_t, _t(labels) > 0, 2), dir_p),
    ]
    for jax_fn, torch_fn, x in cases:
        _close(torch_fn(_t(x)), jax_fn(x), rtol=1e-5)
        got_g, ref_g = _grads(jax_fn, torch_fn, x)
        _close(got_g[0], ref_g[0], rtol=1e-4, atol=1e-7)
