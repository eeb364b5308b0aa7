"""CaDDN's DeepLabV3-ResNet depth network in the port
(glenet_tpu_torch/models/ddn_deeplab.py) against glenet_tpu's DDNDeepLabV3
on the CPU (ResNet blocks (1, 1, 1, 1) at the real widths, 64 x 96 images,
as tests/test_ddn_deeplab.py), its BatchNorm, the converter of
torchvision's state dict, and the BN refresh's per-module momentum.

Tolerances:
  - eval mode: f32 convolutions in two libraries, 1e-5 of each output's
    largest magnitude;
  - train mode: both packages take the BN moments in one pass, E[x^2] -
    E[x]^2, over conv outputs whose mean is up to ~7 x their deviation, so
    each package's summation order moves the variance by ~50 x f32
    rounding and ~20 BNs carry it on: 2e-4 of the largest magnitude; the
    ASPP pool branch normalises B values per channel (2 nearly equal
    ones), with a slope of up to 1 / sqrt(eps) = 316, so its BN's stats
    get 1e-2; with every BN output aligned to JAX's (a shift within those
    bounds, tests/caddn_parity.align_batchnorm_outputs) the outputs are
    held at f32 tolerance;
  - the converter maps a torch module onto a torch module: 1e-5.
"""
import numpy as np
import pytest

pytest.importorskip('jax')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import caddn_parity as cp  # noqa: E402
import torch_parity as tp  # noqa: E402

BLOCKS = (1, 1, 1, 1)
NUM_BINS = 6


def _images(b=2, seed=1):
    return np.random.RandomState(seed).rand(b, 64, 96, 3).astype(np.float32)


def _jax_apply(img, train, capture=False):
    from glenet_tpu.models.ddn_deeplab import DDNDeepLabV3
    jm = DDNDeepLabV3(num_bins=NUM_BINS, blocks=BLOCKS)
    v = tp.random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(img), train=False)), seed=1)
    mutable = ['batch_stats'] + (['intermediates'] if capture else [])
    (feat, logits), new = jm.apply(
        jax.tree.map(jnp.asarray, v), jnp.asarray(img), train=train,
        mutable=mutable,
        capture_intermediates=cp.jax_batchnorm_filter if capture else False)
    return v, np.asarray(feat), np.asarray(logits), jax.tree.map(np.asarray,
                                                                 new)


def _port(variables):
    from glenet_tpu_torch.models.ddn_deeplab import DDNDeepLabV3
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    tm = DDNDeepLabV3(NUM_BINS, BLOCKS)
    load_jax_variables(tm, variables)
    return tm


def _assert_out(got, ref, rel):
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=rel * np.abs(ref).max())


def _assert_stats(tm, new, rtol, pool_rtol):
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    buffers = dict(tm.named_buffers())
    stats = jax_tree_to_port(tm, new['batch_stats'], 'batch_stats')
    assert len(stats) == sum(k.endswith(('running_mean', 'running_var'))
                             for k in tm.state_dict())
    for k, val in stats.items():
        r = pool_rtol if 'bn_pool' in k else rtol
        np.testing.assert_allclose(buffers[k].numpy(), val, rtol=r,
                                   atol=r * np.abs(val).max(), err_msg=k)


def test_ddn_deeplabv3_eval():
    """Layer1's features (B, 16, 24, 256) and the upsampled logits, with
    ImageNet normalisation, at the running stats."""
    img = _images()
    v, feat, logits, _ = _jax_apply(img, train=False)
    tm = _port(v)
    with torch.no_grad():
        tf, tl = tm(torch.from_numpy(img).permute(0, 3, 1, 2), False)
    assert tf.shape == (2, 256, 16, 24) and tl.shape == (2, 7, 16, 24)
    _assert_out(tf, feat, 1e-5)
    _assert_out(tl, logits, 1e-5)


@pytest.mark.parametrize('aligned', [False, True])
def test_ddn_deeplabv3_train(aligned):
    """Train mode: outputs and the BN stats after the forward (momentum
    0.1, biased variance); aligned, each BN output also within its bound
    of JAX's."""
    img = _images()
    v, feat, logits, new = _jax_apply(img, train=True, capture=aligned)
    tm = _port(v)
    hooks = []
    if aligned:
        seen, hooks = cp.align_batchnorm_outputs(
            tm, tp.jax_bn_outputs(new.pop('intermediates')))
    with torch.no_grad():
        tf, tl = tm(torch.from_numpy(img).permute(0, 3, 1, 2), True)
    for h in hooks:
        h.remove()
    rel = 1e-5 if aligned else 2e-4
    _assert_out(tf, feat, rel)
    _assert_out(tl, logits, rel)
    _assert_stats(tm, new, 1e-4, 1e-2)


def test_batchnorm_matches_flax():
    """The port's BatchNorm against flax's nn.BatchNorm as glenet_tpu's
    `_BN` sets it (eps 1e-5, momentum 0.9): outputs, running stats and
    the input's gradient, in train and eval mode, on centred data."""
    import flax.linen as fnn

    from glenet_tpu_torch.models.ddn_deeplab import BatchNorm
    rng = np.random.RandomState(5)
    x = rng.randn(3, 5, 7, 8).astype(np.float32)
    g = rng.randn(3, 5, 7, 8).astype(np.float32)
    scale, bias = rng.rand(8).astype(np.float32) + 0.5, rng.randn(8) * 0.1
    mean, var = rng.randn(8) * 0.1, rng.rand(8) + 0.5
    v = {'params': {'scale': scale, 'bias': bias.astype(np.float32)},
         'batch_stats': {'mean': mean.astype(np.float32),
                         'var': var.astype(np.float32)}}
    for train in (True, False):
        bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                           epsilon=1e-5)

        def f(xx):
            return bn.apply(jax.tree.map(jnp.asarray, v), xx,
                            mutable=['batch_stats'])

        y, new = f(jnp.asarray(x))
        _, vjp = jax.vjp(lambda xx: f(xx)[0], jnp.asarray(x))
        (gx,) = vjp(jnp.asarray(g))
        tm = BatchNorm(8)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(scale))
            tm.bias.copy_(torch.from_numpy(v['params']['bias']))
            tm.running_mean.copy_(torch.from_numpy(
                v['batch_stats']['mean']))
            tm.running_var.copy_(torch.from_numpy(v['batch_stats']['var']))
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        out = tm(tx, train)
        out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
        np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(y), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(gx), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tm.running_mean.numpy(),
                                   np.asarray(new['batch_stats']['mean']),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tm.running_var.numpy(),
                                   np.asarray(new['batch_stats']['var']),
                                   rtol=1e-5, atol=1e-7)


def test_convert_ddn_deeplabv3():
    """A randomly initialised torch mirror of torchvision's
    deeplabv3_resnet (tests/test_ddn_deeplab.py, its state-dict names)
    through convert_ddn_deeplabv3 into the port's DDNDeepLabV3: features
    and logits equal the mirror's; every key is read and every port
    tensor set; the same weights as glenet_tpu's converter gives."""
    from test_ddn_deeplab import TorchDeepLabV3
    import torch.nn as tnn

    from glenet_tpu.utils.weight_converter import \
        convert_ddn_deeplabv3 as jax_convert

    from glenet_tpu_torch.models.ddn_deeplab import DDNDeepLabV3
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    from glenet_tpu_torch.utils.weight_converter import convert_ddn_deeplabv3
    torch.manual_seed(0)
    tm = TorchDeepLabV3().eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.7, 1.5)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    port = DDNDeepLabV3(NUM_BINS, BLOCKS, normalize_input=False).eval()
    converted = convert_ddn_deeplabv3(sd, blocks=BLOCKS)
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in converted.items()})
    used = {k for k in sd if 'num_batches_tracked' not in k}
    assert len(converted) == len(used) == len(port.state_dict())
    img = np.random.RandomState(1).randn(1, 3, 64, 96).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(img))
        got = port(torch.from_numpy(img), False)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-5 * float(r.abs().max()))
    params, stats = jax_convert(sd, blocks=BLOCKS)
    other = DDNDeepLabV3(NUM_BINS, BLOCKS, normalize_input=False)
    load_jax_variables(other, {'params': params, 'batch_stats': stats})
    for k, val in other.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), converted[k], err_msg=k)


def test_caddn_deeplab_config_builds():
    """CaDDN_deeplab.yaml builds at full width: ResNet-101 (3, 4, 23, 3),
    a 256 -> 64 channel_reduce block, 80 LID bins."""
    from pathlib import Path

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    root = Path(__file__).resolve().parent.parent
    cfg = cfg_from_yaml_file(str(root / 'configs/kitti_models/'
                                 'CaDDN_deeplab.yaml'))
    det = build_detector(cfg, device='cpu')
    vfe = det.net.vfe
    assert len(vfe.ddn.backbone.names[2]) == 23
    assert vfe.channel_reduce.Conv_0.weight.shape == (64, 256, 1, 1)
    assert vfe.ddn.head_out.weight.shape[0] == 81
    assert tuple(det.grid_size) == (280, 376, 25)


def test_bn_refresh_takes_each_momentum():
    """The BN refresh inverts each stat's EMA with its module's momentum
    (0.1 for the DeepLabV3 BatchNorm, 0.01 for MaskedBatchNorm) and so
    recovers the pooled moments exactly."""
    from glenet_tpu_torch.models.ddn_deeplab import BatchNorm
    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    from glenet_tpu_torch.train.bn_refresh import (bn_momenta, bn_stats,
                                                   refresh_batch_stats)
    net = torch.nn.Module()
    net.a = BatchNorm(4)
    net.b = MaskedBatchNorm(4, channel_dim=1)
    stats = {k: v.clone() for k, v in bn_stats(net).items()}
    mom = bn_momenta(net, stats)
    assert mom == {'a.running_mean': 0.1, 'a.running_var': 0.1,
                   'b.running_mean': 0.01, 'b.running_var': 0.01}
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randn(6, 4, 3, 3).astype(np.float32)
                                * (i + 1)) for i in range(3)]

    def stats_fn(x):
        for k, live in bn_stats(net).items():
            live.copy_(stats[k])
        with torch.no_grad():
            net.a(x, True)
            net.b(x, use_running_average=False)
        return bn_stats(net)

    out = refresh_batch_stats(stats, batches, stats_fn, mom)
    pooled = torch.cat(batches).double()
    mean = pooled.mean((0, 2, 3)).numpy()
    var = pooled.var((0, 2, 3), unbiased=False).numpy()
    for name in ('a', 'b'):
        np.testing.assert_allclose(out[f'{name}.running_mean'].numpy(), mean,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out[f'{name}.running_var'].numpy(), var,
                                   rtol=1e-4, atol=1e-5)
