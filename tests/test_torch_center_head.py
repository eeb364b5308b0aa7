"""Parity of the port's CenterPoint head (glenet_tpu_torch/models/
center_head.py) with glenet_tpu/models/center_head.py on the CPU, inputs
drawn from numpy seeds:

  - gaussian_radius: the int32 truncation exactly, the radii rtol 1e-5 /
    atol 1e-5 (the third root subtracts two nearly equal terms, so an ulp
    of its square root moves a small radius by ~4e-6);
  - assign_targets_single at CenterPoint's stride 8 (Waymo's 0.1 m voxels)
    and at the pillar configs' stride 1 (0.32 m pillars), with masked,
    zero-sized and out-of-range gts and gts sharing a cell: cell indices
    and valid masks exactly; the heatmap's support and its peaks (the
    cells exactly 1, the focal loss's positives) exactly, its other values
    within 2 ulp (rtol 2.5e-7: torch's and XLA's f32 exp differ in the
    last bit on ~10% of arguments); target boxes atol 1e-6;
  - centernet_focal_loss and center_reg_loss and their gradients against
    jax.vjp: rtol 1e-5 (losses), per tensor max |diff| <= 1e-5 max |grad|
    + 1e-9 (gradients);
  - decode_center_boxes on maps with planted ties (equal logits across
    classes and cells, and a saturated run of scores 1.0): the top-k
    cells, labels and their order exactly, boxes atol 1e-5, scores rtol
    1e-6; k clipped to H * W * C;
  - CenterHead forward (eval and train mode), its BN running stats after
    the train forward and the gradients of every parameter, through the
    weight bridge: values rtol 1e-4 / atol 1e-5, gradients per tensor max
    |diff| <= 2e-4 max |grad| + 1e-6."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

from glenet_tpu.models import center_head as jch  # noqa: E402

from glenet_tpu_torch.models import center_head as tch  # noqa: E402

WAYMO_RANGE = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0)
PILLAR_RANGE = (-74.88, -74.88, -2.0, 74.88, 74.88, 4.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gts(rng, m, lo, hi):
    """m gt boxes with 1-based classes 1..3, some masked off, one of zero
    length, one beyond the range, two in one cell."""
    gt = np.zeros((m, 8), np.float32)
    gt[:, :2] = rng.uniform(lo, hi, (m, 2))
    gt[:, 2] = rng.uniform(-1, 2, m)
    gt[:, 3:6] = rng.uniform([0.4, 0.4, 0.8], [6.0, 2.6, 3.0], (m, 3))
    gt[:, 6] = rng.uniform(-np.pi, np.pi, m)
    gt[:, 7] = rng.randint(1, 4, m)
    gt[1, 3] = 0.0
    gt[2, :2] = hi + 5.0
    gt[4, :2] = gt[3, :2] + 0.01
    mask = rng.uniform(0, 1, m) > 0.15
    mask[1:5] = True
    return gt, mask


def test_gaussian_radius():
    rng = np.random.RandomState(0)
    dx = rng.uniform(0.05, 60.0, 4000).astype(np.float32)
    dy = rng.uniform(0.05, 30.0, 4000).astype(np.float32)
    for overlap in (0.1, 0.5, 0.7):
        ref = np.asarray(jax.jit(lambda a, b: jch.gaussian_radius(
            a, b, overlap))(jnp.asarray(dx), jnp.asarray(dy)))
        got = tch.gaussian_radius(_t(dx), _t(dy), overlap).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.astype(np.int32),
                                      ref.astype(np.int32))


@pytest.mark.parametrize('case', ['stride8', 'stride1'])
def test_assign_targets(case):
    rng = np.random.RandomState(1)
    if case == 'stride8':
        stride, vs, pr, size = 8, (0.1, 0.1, 0.15), WAYMO_RANGE, (188, 188)
        gt, mask = _gts(rng, 48, -70.0, 70.0)
    else:
        # the pillar configs' stride-1 map, cut to 120 x 96 cells
        stride, vs, pr, size = 1, (0.32, 0.32, 6.0), PILLAR_RANGE, (120, 96)
        gt, mask = _gts(rng, 48, -74.0, -74.88 + 30.0)
    ref = jax.jit(lambda g, m: jch.assign_targets_single(
        g, m, 3, size, stride, vs, pr, 0.1, 2))(jnp.asarray(gt),
                                                 jnp.asarray(mask))
    hm_r, box_r, inds_r, mask_r = (np.asarray(r) for r in ref)
    hm, box, inds, valid = (t.numpy() for t in tch.assign_targets_single(
        _t(gt), _t(mask), 3, size, stride, vs, pr, 0.1, 2))
    np.testing.assert_array_equal(inds, inds_r)
    np.testing.assert_array_equal(valid, mask_r)
    assert valid.sum() >= 30 and not valid[1]
    np.testing.assert_array_equal(hm == 1.0, hm_r == 1.0)
    np.testing.assert_array_equal(hm > 0, hm_r > 0)
    assert (hm_r == 1.0).sum() >= 25
    np.testing.assert_allclose(hm, hm_r, rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(box, box_r, rtol=0, atol=1e-6)


def _loss_case(seed=2):
    rng = np.random.RandomState(seed)
    gt, mask = _gts(rng, 16, -20.0, 20.0)
    hm, box, inds, valid = tch.assign_targets_single(
        _t(gt), _t(mask), 3, (48, 40), 8, (0.1, 0.1, 0.15), WAYMO_RANGE)
    logits = rng.randn(2, 3, 40, 48).astype(np.float32) * 2 - 2
    maps = rng.randn(2, 40, 48, 8).astype(np.float32)
    return (logits, np.stack([hm.numpy()] * 2), maps,
            np.stack([box.numpy()] * 2), np.stack([inds.numpy()] * 2),
            np.stack([valid.numpy()] * 2).astype(np.float32))


def _assert_grad(g, g_ref):
    tol = 1e-5 * np.abs(g_ref).max() + 1e-9
    assert np.abs(g - g_ref).max() <= tol, np.abs(g - g_ref).max()


def test_focal_loss_and_gradient():
    logits, hm, *_ = _loss_case()
    assert (hm == 1.0).sum() > 0
    ref, vjp = jax.vjp(lambda x: jch.centernet_focal_loss(x, jnp.asarray(hm)),
                       jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    loss = tch.centernet_focal_loss(x, _t(hm))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    _assert_grad(x.grad.numpy(), np.asarray(vjp(jnp.ones(()))[0]))


def test_reg_loss_and_gradient():
    _, _, maps, box, inds, valid = _loss_case()
    ref, vjp = jax.vjp(lambda m: jch.center_reg_loss(
        m, jnp.asarray(box), jnp.asarray(inds), jnp.asarray(valid)),
        jnp.asarray(maps))
    m = _t(maps).requires_grad_()
    loss = tch.center_reg_loss(m, _t(box), _t(inds), _t(valid))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    _assert_grad(m.grad.numpy(), np.asarray(vjp(jnp.ones(()))[0]))


def _decode_maps(h=12, w=10, c=3):
    """Maps whose heatmap logits repeat: each of 8 values across cells and
    classes, and a run at 30 where the sigmoid is exactly 1."""
    rng = np.random.RandomState(4)
    levels = np.linspace(-3, 3, 8).astype(np.float32)
    hm = levels[rng.randint(0, 8, (2, h, w, c))]
    hm[0, :3, :4] = 30.0
    hm[1, 5, :, 1] = 30.0
    out = {'hm': hm}
    for name, ch in (('center', 2), ('center_z', 1), ('dim', 3), ('rot', 2)):
        out[name] = rng.randn(2, h, w, ch).astype(np.float32)
    return out


@pytest.mark.parametrize('k,thresh', [(50, 0.0), (200, 0.3), (1000, 0.1)])
def test_decode_planted_ties(k, thresh):
    out = _decode_maps()
    args = ((0.32, 0.32, 6.0), PILLAR_RANGE, 1)
    ref = jax.jit(lambda o: jch.decode_center_boxes(
        o, k, *args, score_thresh=thresh))({n: jnp.asarray(v)
                                            for n, v in out.items()})
    boxes_r, scores_r, labels_r = (np.asarray(r) for r in ref)
    boxes, scores, labels = tch.decode_center_boxes(
        {n: _t(v) for n, v in out.items()}, k, *args, score_thresh=thresh)
    assert boxes.shape == (2, min(k, 12 * 10 * 3), 7)
    # ties decide the order: the same score repeats within the top k
    assert len(np.unique(scores_r[0])) < scores_r.shape[1] / 4
    np.testing.assert_array_equal(labels.numpy(), labels_r)
    np.testing.assert_allclose(boxes.numpy(), boxes_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), scores_r, rtol=1e-6, atol=0)


def test_center_head_module():
    """CenterHead with USE_BIAS_BEFORE_NORM, 3 classes, 16 shared channels
    on a 12 x 10 map of 24 channels: eval and train outputs, BN stats,
    gradients of sum(out * w) over every parameter.  A bias that a
    train-mode BN follows has an exact gradient of 0 (the batch mean takes
    it out); both packages return rounding noise there, so those six are
    held to 1e-4 of their conv kernel's largest |gradient| on both sides."""
    from glenet_tpu_torch.utils.jax_weights import (jax_tree_to_port,
                                                    load_jax_variables)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 12, 10, 24).astype(np.float32)
    jmod = jch.CenterHead(num_class=3, shared_ch=16,
                          use_bias_before_norm=True)
    tmod = tch.CenterHead(24, 3, 16, use_bias_before_norm=True)
    w = {name: rng.randn(2, 12, 10, 3 if ch is None else ch)
         .astype(np.float32) for name, ch in tch.HEADS}
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    v = tp.random_variables(shapes, seed=5)
    load_jax_variables(tmod, v)
    with torch.no_grad():
        got = tmod(_t(x), train=False)
    ref = jmod.apply(v, jnp.asarray(x), train=False)
    for k in w:
        tp.assert_close(got[k], ref[k], err_msg=f'eval {k}')

    def loss(params):
        out, state = jmod.apply({'params': params,
                                 'batch_stats': v['batch_stats']},
                                jnp.asarray(x), train=True,
                                mutable=['batch_stats'])
        return sum((out[k] * w[k]).sum() for k in w), (out, state)

    grads, (ref_out, state) = jax.grad(loss, has_aux=True)(v['params'])
    got = tmod(_t(x), train=True)
    for k in w:
        tp.assert_close(got[k].detach(), ref_out[k], err_msg=f'train {k}')
    sum((got[k] * _t(w[k])).sum() for k in w).backward()
    buffers = dict(tmod.named_buffers())
    stats = jax_tree_to_port(tmod, state['batch_stats'], 'batch_stats')
    assert len(stats) == 12
    for k, r in stats.items():
        tp.assert_close(buffers[k], r, err_msg=k)
    ref_g = jax_tree_to_port(tmod, grads)
    params = dict(tmod.named_parameters())
    assert set(ref_g) == set(params)
    before_bn = {f'{n}_0.bias' for n, _ in tch.HEADS} | {'Conv_0.bias'}
    for k, g_ref in ref_g.items():
        g = params[k].grad.numpy()
        if k in before_bn:
            bound = 1e-4 * np.abs(ref_g[k.replace('bias', 'weight')]).max()
            assert np.abs(g).max() <= bound and np.abs(g_ref).max() <= bound
            continue
        tol = 2e-4 * np.abs(g_ref).max() + 1e-6
        assert np.abs(g - g_ref).max() <= tol, (k, np.abs(g - g_ref).max())


def test_center_head_init():
    """The heatmap's bias starts at flax's -2.19, every other bias at 0."""
    head = tch.CenterHead(8, 3, 16, use_bias_before_norm=True)
    assert torch.equal(head.hm_1.bias, torch.full((3,), -2.19))
    others = [m.bias for n, m in head.named_children()
              if isinstance(m, torch.nn.Conv2d) and n != 'hm_1']
    assert len(others) == 10 and all(not b.any() for b in others)
