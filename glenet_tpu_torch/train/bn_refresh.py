"""Re-estimation of the BatchNorm running statistics after training (the
port's counterpart of glenet_tpu/train/bn_refresh.py).

BN running stats are an EMA with momentum BN_MOMENTUM (0.01); a short run
leaves them several time constants short of the true activation moments.
This recomputes them exactly: one train-mode forward per batch updates the
stats once from their current values, the EMA update is inverted to recover
that batch's raw moments, and the batches are pooled with the law of total
variance:

    mean  = E_b[mean_b]
    var   = E_b[var_b] + E_b[mean_b^2] - mean^2

which equals the moments over the pooled data when the batches are equal in
size.  The inversion and the pooling run in float64.  Each stat's EMA is
inverted with its own BN's momentum: CaDDN's DeepLabV3 depth network moves
its stats by 0.1 (glenet_tpu's refresh inverts every stat with 0.01).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.layers import BN_MOMENTUM
from .state import step_generator

_MEAN, _VAR = 'running_mean', 'running_var'


def refresh_batch_stats(stats, batches, stats_fn, momentum):
    """Re-estimate every {running_mean, running_var} pair over `batches`.

    stats:    {name: tensor} of the current running stats, names ending in
              'running_mean' / 'running_var' in pairs.
    stats_fn: batch -> {name: tensor}, the stats after ONE train-mode
              forward that starts from `stats`.
    momentum: the EMA momentum of the BN layers (new = (1 - m) * old
              + m * batch), one number or {name: momentum}.

    Returns {name: f32 tensor} of exact pooled moments (`stats` itself when
    there are no stats or no batches).
    """
    if not stats:
        return stats
    names = list(stats)
    old = {k: stats[k].detach().cpu().double().numpy() for k in names}

    # one train-mode forward per batch; invert the EMA update to recover
    # that batch's raw moments (per-channel vectors, cheap to keep)
    mom = momentum if isinstance(momentum, dict) else \
        {k: momentum for k in names}
    per_batch = []
    for batch in batches:
        new = stats_fn(batch)
        per_batch.append({
            k: (new[k].detach().cpu().double().numpy()
                - (1.0 - mom[k]) * old[k]) / mom[k] for k in names})
    if not per_batch:
        return stats

    refreshed = {}
    for k in names:
        avg = np.mean([pb[k] for pb in per_batch], axis=0)
        if k.endswith(_MEAN):
            out = avg
        else:
            mk = k[:-len(_VAR)] + _MEAN
            pooled_mean = np.mean([pb[mk] for pb in per_batch], axis=0)
            mean_sq = np.mean([pb[mk] ** 2 for pb in per_batch], axis=0)
            out = np.clip(avg + mean_sq - pooled_mean * pooled_mean, 0.0,
                          None)
        refreshed[k] = torch.from_numpy(out.astype(np.float32))
    return refreshed


def bn_stats(net):
    """{name: buffer} of every BN running stat of `net` (the live tensors)."""
    return {k: v for k, v in net.named_buffers()
            if k.endswith((_MEAN, _VAR))}


def bn_momenta(net, names):
    """{stat name: the EMA momentum of its BN}: a module's `momentum`
    (the DeepLabV3 depth network's BatchNorm: 0.1), else BN_MOMENTUM."""
    return {k: getattr(net.get_submodule(k.rsplit('.', 1)[0]), 'momentum',
                       BN_MOMENTUM) for k in names}


@torch.no_grad()
def refresh_detector_stats(det, batches):
    """Re-estimate a Detector's BN running stats in place over `batches`
    (dicts of tensors on its device with the gt fields, optionally fixed
    `roi_targets`), each through one train-mode `loss_fn` forward with its
    own step generator.  Returns the refreshed stats."""
    live = bn_stats(det.net)
    start = {k: v.clone() for k, v in live.items()}
    calls = [0]

    def stats_fn(batch):
        for k, v in live.items():
            v.copy_(start[k])
        calls[0] += 1
        det.loss_fn(batch, generator=step_generator(calls[0], det.device))
        return live

    refreshed = refresh_batch_stats(start, batches, stats_fn,
                                    bn_momenta(det.net, start))
    for k, v in live.items():
        v.copy_(refreshed[k])
    return refreshed
