"""The option pieces of the nuScenes / Lyft models against glenet_tpu's, on
the CPU, same numpy-drawn inputs and weights:

  - ResidualCoder(encode_angle_by_sincos=True) (code size 8, with and
    without extra columns): encode and decode atol 1e-5, and the
    decode of its own encode back to the boxes;
  - PreviousResidualDecoder's decode atol 1e-5, and build_box_coder for
    every coder name;
  - BaseBEVBackbone with fractional UPSAMPLE_STRIDES [0.5, 1, 2] (as
    OpenPCDet's cbgs_pp_multihead.yaml), weights through
    utils/jax_weights: the eval-mode forward, the train-mode forward and
    its BN running stats, rtol 1e-4 / atol 1e-5;
  - MLP (Dense -> MaskedBatchNorm -> ReLU), masked and not, with and
    without BN and the last ReLU: forward and train-mode BN stats, rtol
    1e-5 / atol 1e-5;
  - nms_normal and soft_nms (gaussian and linear): keep indices and
    validity exactly (score ties included, argmax's first index), the
    kept scores atol 1e-6."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from glenet_tpu.models import bev_backbone as jbev  # noqa: E402
from glenet_tpu.models import layers as jl  # noqa: E402
from glenet_tpu.ops import nms as jnms  # noqa: E402
from glenet_tpu.utils import box_coder as jcoder  # noqa: E402

import torch_parity as tp  # noqa: E402
from glenet_tpu_torch.models import bev_backbone as tbev  # noqa: E402
from glenet_tpu_torch.models import layers as tl  # noqa: E402
from glenet_tpu_torch.ops import nms as tnms  # noqa: E402
from glenet_tpu_torch.utils import box_coder as tcoder  # noqa: E402
from glenet_tpu_torch.utils.jax_weights import (  # noqa: E402
    jax_tree_to_port, load_jax_variables)


def _boxes(rng, n, extra=0):
    b = np.zeros((n, 7 + extra), np.float32)
    b[:, :2] = rng.uniform(-40, 40, (n, 2))
    b[:, 2] = rng.uniform(-2, 1, n)
    b[:, 3:6] = rng.uniform(0.4, 6.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:] = rng.uniform(-5, 5, (n, extra))
    return b


@pytest.mark.parametrize('extra', [0, 2])
def test_sincos_residual_coder(extra):
    rng = np.random.RandomState(extra)
    boxes, anchors = _boxes(rng, 64, extra), _boxes(rng, 64, extra)
    jc = jcoder.ResidualCoder(encode_angle_by_sincos=True)
    tc = tcoder.build_box_coder('ResidualCoder', encode_angle_by_sincos=True)
    assert tc.code_size == jc.code_size == 8
    ref = np.asarray(jc.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    got = tc.encode(torch.from_numpy(boxes), torch.from_numpy(anchors))
    assert got.shape == (64, 8 + extra)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    enc = rng.uniform(-0.5, 0.5, (64, 8 + extra)).astype(np.float32)
    ref = np.asarray(jc.decode(jnp.asarray(enc), jnp.asarray(anchors)))
    got = tc.decode(torch.from_numpy(enc), torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    back = tc.decode(tc.encode(torch.from_numpy(boxes),
                               torch.from_numpy(anchors)),
                     torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(back[:, :6], boxes[:, :6], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(np.cos(back[:, 6] - boxes[:, 6]), 1.0,
                               atol=1e-5)


def test_previous_residual_decoder():
    rng = np.random.RandomState(3)
    anchors = _boxes(rng, 64)
    enc = rng.uniform(-0.5, 0.5, (64, 7)).astype(np.float32)
    ref = jcoder.PreviousResidualDecoder().decode(jnp.asarray(enc),
                                                  jnp.asarray(anchors))
    coder = tcoder.build_box_coder('PreviousResidualDecoder')
    got = coder.decode(torch.from_numpy(enc), torch.from_numpy(anchors))
    assert coder.code_size == 7
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize('name', ['ResidualCoder', 'PointResidualCoder',
                                  'PreviousResidualDecoder'])
def test_build_box_coder(name):
    assert type(tcoder.build_box_coder(name)).__name__ == type(
        jcoder.build_box_coder(name)).__name__ == name
    with pytest.raises(NotImplementedError, match='Nope'):
        tcoder.build_box_coder('Nope')


# cbgs_pp_multihead.yaml's BEV backbone, narrow
FRACTIONAL = dict(layer_nums=(1, 1, 1), layer_strides=(2, 2, 2),
                  num_filters=(8, 16, 24), upsample_strides=(0.5, 1, 2),
                  num_upsample_filters=(8, 8, 8))


def _module_pair(jmod, tmod, x, seed, **apply_kw):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x,
                                              **apply_kw))
    variables = tp.random_variables(shapes, seed)
    load_jax_variables(tmod, variables)
    return variables


def test_fractional_stride_backbone():
    """[0.5, 1, 2] over levels of stride 2, 4, 8: every up-branch lands at
    stride 4, the 0.5 one a 2 x 2 conv of stride 2 (ConvBlock_2.Conv_0)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 24, 6).astype(np.float32)
    jm = jbev.BaseBEVBackbone(**FRACTIONAL)
    tm = tbev.BaseBEVBackbone(6, **FRACTIONAL)
    assert tuple(tm.ConvBlock_2.Conv_0.weight.shape) == (8, 8, 2, 2)
    assert tm.ConvBlock_2.Conv_0.stride == (2, 2)
    v = _module_pair(jm, tm, x, 1, train=False)
    with tp.pinned_f32(), torch.no_grad():
        ref = jm.apply(v, x, train=False)
        got = tm(torch.from_numpy(x), train=False)
        assert got.shape == (2, 8, 6, 24) == ref.shape
        tp.assert_close(got, np.asarray(ref))
        ref, new = jm.apply(v, x, train=True, mutable=['batch_stats'])
        got = tm.train()(torch.from_numpy(x), train=True)
    tp.assert_close(got, np.asarray(ref))
    stats = jax_tree_to_port(tm, new['batch_stats'], 'batch_stats')
    buffers = dict(tm.named_buffers())
    assert len(stats) == 2 * 9
    for k, val in stats.items():
        tp.assert_close(buffers[k], val, err_msg=k)


@pytest.mark.parametrize('masked,use_bn,final', [
    (True, True, True), (False, True, False), (True, False, True)])
def test_mlp(masked, use_bn, final):
    rng = np.random.RandomState(int(masked) + 2 * int(use_bn))
    x = (rng.randn(3, 40, 7) * 2 + 0.3).astype(np.float32)
    mask = rng.rand(3, 40) > 0.3 if masked else None
    jm = jl.MLP(features=(16, 8), use_bn=use_bn, final_activation=final)
    tm = tl.MLP(7, (16, 8), use_bn=use_bn, final_activation=final)
    v = _module_pair(jm, tm, x, 2, mask=mask, train=False)
    tmask = None if mask is None else torch.from_numpy(mask)
    ref = jm.apply(v, x, mask=mask, train=False)
    got = tm(torch.from_numpy(x), mask=tmask, train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    if not use_bn:
        assert not final or (got >= 0).all()
        return
    ref, new = jm.apply(v, x, mask=mask, train=True, mutable=['batch_stats'])
    got = tm(torch.from_numpy(x), mask=tmask, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    if masked:
        assert (got[~tmask] == 0).all()
    buffers = dict(tm.named_buffers())
    for k, val in jax_tree_to_port(tm, new['batch_stats'],
                                   'batch_stats').items():
        np.testing.assert_allclose(buffers[k].numpy(), val, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _nms_boxes(seed, n, spread):
    rng = np.random.RandomState(seed)
    b = _boxes(rng, n)
    b[:, :2] = rng.uniform(0, spread, (n, 2))
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[::9] = scores[4]                    # ties: the lower index first
    return b, scores


@pytest.mark.parametrize('n,pre_max,post_max', [(4096, 4096, 500),
                                                (300, 256, 64)])
def test_nms_normal(n, pre_max, post_max):
    boxes, scores = _nms_boxes(n, n, 120.0 if n > 1000 else 30.0)
    ref_idx, ref_valid = jnms.nms_normal(boxes, scores, 0.2, pre_max=pre_max,
                                         post_max=post_max,
                                         score_threshold=0.1)
    idx, valid = tnms.nms_normal(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), 0.2,
                                 pre_max=pre_max, post_max=post_max,
                                 score_threshold=0.1)
    ref_valid = np.asarray(ref_valid)
    assert 0 < ref_valid.sum()
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(idx.numpy()[ref_valid],
                                  np.asarray(ref_idx)[ref_valid])


def _car_boxes(seed, n, spread):
    """Car-sized boxes within +-spread m (test_torch_nms.py's sizes)."""
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3] = rng.uniform(2.5, 4.5, n)
    b[:, 4] = rng.uniform(1.2, 2.0, n)
    b[:, 5] = rng.uniform(1.2, 1.8, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[::9] = scores[4]                    # ties: the lower index first
    return b, scores


@pytest.mark.parametrize('mode', ['gaussian', 'linear'])
@pytest.mark.parametrize('jax_iou', [True, False])
def test_soft_nms(mode, jax_iou, monkeypatch):
    """1024 boxes within +-10 m, sigma 0.3, 256 rounds.  With jax_iou the
    port's soft_nms takes glenet_tpu's rotated-IoU matrix, so the rounds
    alone are compared: indices exact, scores atol 1e-6.  With its own
    IoUs (f32 polygon clipping that agrees with glenet_tpu's to ~1e-5,
    test_torch_nms.py) the indices are exact and the scores atol 1e-5."""
    from glenet_tpu.ops import iou3d as jiou

    from glenet_tpu_torch.ops import iou3d as tiou
    boxes, scores = _car_boxes(7, 1024, 10.0)
    if jax_iou:
        monkeypatch.setattr(tiou, 'boxes_iou_bev_blocked', lambda a, b: (
            torch.from_numpy(np.asarray(jiou.boxes_iou_bev_blocked(
                a.numpy(), b.numpy())))))
    ref = jnms.soft_nms(boxes, scores, score_threshold=0.1, soft_sigma=0.3,
                        soft_mode=mode, pre_max=1024, post_max=256)
    got = tnms.soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                        score_threshold=0.1, soft_sigma=0.3,
                        soft_mode=mode, pre_max=1024, post_max=256)
    ref_idx, ref_valid, ref_scores = (np.asarray(r) for r in ref)
    idx, valid, kept = (g.numpy() for g in got)
    assert ref_valid.sum() == 256
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(kept, ref_scores, rtol=0,
                               atol=1e-6 if jax_iou else 1e-5)
    # the rounds rescaled the scores of boxes kept after an overlapping one
    assert (kept < scores[idx]).sum() > 40
