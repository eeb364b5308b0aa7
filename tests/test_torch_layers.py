"""The port's MaskedBatchNorm (glenet_tpu_torch/models/layers.py) against
glenet_tpu's: masked moments and running-stat updates in train mode,
running stats in eval mode and under BN_FORCE_RUNNING_STATS.  f32 sums in
another order: rtol 1e-5 / atol 1e-6."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

from glenet_tpu.models import layers as jl  # noqa: E402

from glenet_tpu_torch.models import layers as tl  # noqa: E402

C = 6


def _inputs(seed):
    r = np.random.RandomState(seed)
    x = r.randn(3, 17, C).astype(np.float32) * 2 + 0.5
    mask = r.rand(3, 17) > 0.3
    stats = {'mean': r.randn(C).astype(np.float32) * 0.1,
             'var': r.uniform(0.5, 1.5, C).astype(np.float32)}
    params = {'scale': r.uniform(0.5, 1.5, C).astype(np.float32),
              'bias': r.randn(C).astype(np.float32) * 0.1}
    return x, mask, params, stats


def _port_bn(params, stats, eps):
    bn = tl.MaskedBatchNorm(C, eps=eps)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params['scale']))
        bn.bias.copy_(torch.from_numpy(params['bias']))
        bn.running_mean.copy_(torch.from_numpy(stats['mean']))
        bn.running_var.copy_(torch.from_numpy(stats['var']))
    return bn


@pytest.mark.parametrize('train,force,masked', [
    (True, False, True), (True, False, False), (False, False, True),
    (True, True, True)])
def test_masked_batchnorm(train, force, masked, monkeypatch):
    monkeypatch.setattr(jl, 'BN_FORCE_RUNNING_STATS', force)
    monkeypatch.setattr(tl, 'BN_FORCE_RUNNING_STATS', force)
    x, mask, params, stats = _inputs(int(train) + 2 * int(force))
    m = mask if masked else None
    ref, new = jl.MaskedBatchNorm(eps=1e-5).apply(
        {'params': params, 'batch_stats': stats}, x, mask=m,
        use_running_average=not train, mutable=['batch_stats'])
    bn = _port_bn(params, stats, 1e-5)
    got = bn(torch.from_numpy(x), mask=None if m is None
             else torch.from_numpy(m), use_running_average=not train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new['batch_stats']['mean']),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new['batch_stats']['var']),
                               rtol=1e-5, atol=1e-6)
