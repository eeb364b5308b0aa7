"""GLENet CVAE (torch counterpart of glenet_tpu/cvae/model.py): a
conditional VAE over per-object point crops whose stochastic box
predictions give, across samples, each label's variance.

The reference's conventions are kept as they are:
  - the KL takes sigma = exp(logvar) + 3e-22 (logvar acts as a log-std
    there), while the reparametrisation uses std = exp(0.5 * logvar);
  - PointNetFeat: Dense 64x / 128x / 512x + BN, no ReLU before the global
    max-pool;
  - generator output: [center(3), size(3), heading(1), dir_bins(2)];
  - losses: sin-difference smooth-L1 on dims :7, direction-bin CE, the KL
    (annealed by the trainer), and 1e-4 * the sum of the parameters' L2
    norms.

Attribute names follow the JAX package's variable tree (`x_encoder.
PointNetFeat_0.Dense_0`, `obj_encoder.fc_ce_2`, ...), so
utils/jax_weights.py maps its variables onto these modules.  Dense layers
are nn.Linear on the last axis; BatchNorms are MaskedBatchNorm with flax's
eps 1e-5 (flax's momentum 0.99 is the port's BN_MOMENTUM 0.01), moments
over every axis but the channel axis.  The max-pool is torch.amax, which
splits the gradient evenly over tied maxima as JAX does (crops are
resampled with replacement, so ties are common).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import MaskedBatchNorm
from ..utils import common, losses

BN_EPS = 1e-5
KL_SIGMA_EPS = 3e-22


def draw_eps(shape, generator, device):
    """The standard-normal draws of the reparametrisation: every eps of the
    train forward and of `sample` comes from here."""
    return torch.randn(shape, generator=generator, device=device)


def lecun_normal_(weight, generator=None):
    """flax's default Dense kernel init on a (out, in) weight: a normal
    truncated at 2 std with variance 1 / fan_in after the truncation."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class _PointFeat(nn.Module):
    """Three Dense + BN blocks on (B, N, C) points (ReLU after the first
    two), then the max over the points: (B, widths[-1])."""

    def __init__(self, in_ch: int, widths):
        super().__init__()
        for i, w in enumerate(widths):
            setattr(self, f'Dense_{i}', nn.Linear(in_ch, w))
            setattr(self, f'BatchNorm_{i}', MaskedBatchNorm(w, eps=BN_EPS))
            in_ch = w
        self.depth = len(widths)

    def forward(self, pts, train: bool = True):
        h = pts
        for i in range(self.depth):
            h = getattr(self, f'Dense_{i}')(h)
            h = getattr(self, f'BatchNorm_{i}')(
                h, use_running_average=not train)
            if i < self.depth - 1:
                h = F.relu(h)
        return torch.amax(h, dim=1)


class PointNetFeat(_PointFeat):
    """(B, N, C) points -> (B, 512 * x) global features."""

    def __init__(self, in_ch: int, x: float = 1.0):
        super().__init__(in_ch, [int(64 * x), int(128 * x), int(512 * x)])


class SimPointNetFeat(_PointFeat):
    """(B, N, C) points -> (B, 16 * x) global features."""

    def __init__(self, in_ch: int, x: float = 1.0):
        super().__init__(in_ch, [int(16 * x)] * 3)


class EncoderX(nn.Module):
    """Prior encoder: points -> (mu, logvar)."""

    def __init__(self, in_ch: int, latent_size: int = 3, x: float = 1.0):
        super().__init__()
        self.PointNetFeat_0 = PointNetFeat(in_ch, x)
        self.Dense_0 = nn.Linear(int(512 * x), latent_size)
        self.Dense_1 = nn.Linear(int(512 * x), latent_size)

    def forward(self, pts, train: bool = True):
        feat = self.PointNetFeat_0(pts, train=train)
        return self.Dense_0(feat), self.Dense_1(feat)


class EncoderXY(nn.Module):
    """Posterior encoder: points + the 8-dim gt box encoding -> (mu,
    logvar)."""

    def __init__(self, in_ch: int, latent_size: int = 3, x: float = 1.0):
        super().__init__()
        self.PointNetFeat_0 = PointNetFeat(in_ch, x)
        self.Dense_0 = nn.Linear(int(512 * x) + 8, latent_size)
        self.Dense_1 = nn.Linear(int(512 * x) + 8, latent_size)

    def forward(self, pts, y, train: bool = True):
        feat = torch.cat([self.PointNetFeat_0(pts, train=train), y], dim=1)
        return self.Dense_0(feat), self.Dense_1(feat)


class ObjectFeatEncoder(nn.Module):
    """Decoder: points + z -> [center(3), size(3), heading(1), dir(2)]."""
    WIDTH = 64          # 256 * fc_scale (0.25)
    HEADS = (('fc_ce', 3), ('fc_s', 3), ('fc_hr', 1), ('fc_dir', None))

    def __init__(self, in_ch: int, latent_dim: int = 3, num_bins: int = 2):
        super().__init__()
        w = self.WIDTH
        self.SimPointNetFeat_0 = SimPointNetFeat(in_ch, x=0.5)   # 8-dim
        self.fc1 = nn.Linear(8 + latent_dim, w)
        self.BatchNorm_0 = MaskedBatchNorm(w, eps=BN_EPS)
        self.fc2 = nn.Linear(w, w)
        self.BatchNorm_1 = MaskedBatchNorm(w, eps=BN_EPS)
        for name, out in self.HEADS:
            setattr(self, f'{name}_1', nn.Linear(w, w))
            setattr(self, f'{name}_2', nn.Linear(w, out or num_bins,
                                                 bias=False))

    def forward(self, pts, z, train: bool = True):
        h = torch.cat([self.SimPointNetFeat_0(pts, train=train), z], dim=1)
        h = F.relu(self.BatchNorm_0(self.fc1(h),
                                    use_running_average=not train))
        feat = F.relu(self.BatchNorm_1(self.fc2(h),
                                       use_running_average=not train))
        return torch.cat([
            getattr(self, f'{name}_2')(F.relu(getattr(self, f'{name}_1')(feat)))
            for name, _ in self.HEADS], dim=1)


class CVAEGenerator(nn.Module):
    """The whole GLENet generator: `forward` is the train forward, `sample`
    the inference."""

    def __init__(self, latent_dim: int = 3, num_bins: int = 2,
                 scale: float = 1.0, in_channels: int = 4):
        super().__init__()
        self.num_bins = num_bins
        self.obj_encoder = ObjectFeatEncoder(in_channels, latent_dim, num_bins)
        self.xy_encoder = EncoderXY(in_channels, latent_dim, scale)
        self.x_encoder = EncoderX(in_channels, latent_dim, scale)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's init: lecun_normal kernels, zero biases, BN scale 1 and
        bias 0, running mean 0 and var 1."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MaskedBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def forward(self, pts, y, generator=None, train: bool = True):
        """Train forward.  pts (B, N, C); y (B, 8) gt box encoding.
        Returns box_pred_post (B, 9), kl (B,), mus / logvars."""
        mu_post, logvar_post = self.xy_encoder(pts, y, train=train)
        mu_prior, logvar_prior = self.x_encoder(pts, train=train)

        sp = torch.exp(logvar_post) + KL_SIGMA_EPS
        pp = torch.exp(logvar_prior) + KL_SIGMA_EPS
        kl = (torch.log(pp / sp)
              + (sp ** 2 + (mu_post - mu_prior) ** 2) / (2.0 * pp ** 2)
              - 0.5).sum(dim=1)

        eps = draw_eps(mu_post.shape, generator, mu_post.device)
        z_post = mu_post + torch.exp(0.5 * logvar_post) * eps
        return {
            'box_pred_post': self.obj_encoder(pts, z_post, train=train),
            'kl': kl,
            'mu_post': mu_post, 'logvar_post': logvar_post,
            'mu_prior': mu_prior, 'logvar_prior': logvar_prior,
        }

    def sample(self, pts, generator=None, dir_offset=0.78539,
               dir_limit_offset=0.0):
        """Inference: z from the prior (reparametrised), decoded, heading
        corrected by the direction bin.  Returns (B, 7) boxes."""
        mu, logvar = self.x_encoder(pts, train=False)
        eps = draw_eps(mu.shape, generator, mu.device)
        z = mu + torch.exp(0.5 * logvar) * eps
        pred = self.obj_encoder(pts, z, train=False)

        dir_labels = pred[:, -self.num_bins:].argmax(dim=-1)
        period = 2 * math.pi / self.num_bins
        dir_rot = common.limit_period(pred[:, 6] - dir_offset,
                                      dir_limit_offset, period)
        heading = dir_rot + dir_offset + period * dir_labels.to(pred.dtype)
        return torch.cat([pred[:, :6], heading[:, None]], dim=1)


def cvae_loss(out, gt_boxes7, params, loss_weights, num_bins=2,
              dir_offset=0.78539):
    """(reg_loss, latent_loss, regular_loss, {'loss_loc', 'loss_dir'}):
      reg = sin-diff smooth-L1(pred[:, :7], gt7).sum() / B * loc_weight
          + CE(dir logits, dir bin of the gt heading).sum() / B * dir_weight
      latent = mean(KL) * latent_weight   (the trainer anneals it)
      regular = 1e-4 * sum over `params` (the parameters, never the BN
                running stats) of sqrt(sum p^2 + 1e-12)."""
    pred = out['box_pred_post']
    b = pred.shape[0]
    pred_sin, gt_sin = losses.add_sin_difference(pred[None, :, :7],
                                                 gt_boxes7[None])
    loc = losses.weighted_smooth_l1(
        pred_sin, gt_sin,
        code_weights=loss_weights.get('code_weights', None)).sum() / b
    loc = loc * loss_weights['loc_weight']

    offset_rot = common.limit_period(gt_boxes7[:, 6] - dir_offset, 0,
                                     2 * math.pi)
    dir_t = torch.clamp(torch.floor(offset_rot / (2 * math.pi / num_bins)),
                        0, num_bins - 1).long()
    one_hot = F.one_hot(dir_t[:, None], num_bins).to(pred.dtype)
    dir_loss = losses.weighted_cross_entropy(
        pred[:, None, -num_bins:], one_hot,
        torch.ones((b, 1), dtype=pred.dtype, device=pred.device)).sum() / b
    dir_loss = dir_loss * loss_weights['dir_weight']

    latent = out['kl'].mean() * loss_weights['latent_weight']
    sq = torch.stack([(p * p).sum() for p in params])
    regular = 1e-4 * torch.sqrt(sq + 1e-12).sum()
    return loc + dir_loss, latent, regular, {'loss_loc': loc,
                                             'loss_dir': dir_loss}
