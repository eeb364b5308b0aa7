"""PointNet++ backbone (torch counterpart of
glenet_tpu/models/pointnet2_backbone.py): the shared MLP that PV-RCNN's
set abstraction applies to every grouped neighbour, and PointRCNN's
PointNet2MSG (set-abstraction levels with multi-scale grouping, then
feature-propagation levels back to every input point).

The masks follow the JAX package exactly:
  - a set-abstraction level's centres keep the mask gathered at their FPS
    indices (an empty ball does not clear it);
  - the grouped shared MLP takes its BN moments over every grouped row,
    empty balls included; only then are the empty balls zeroed and the
    neighbours max-pooled;
  - a feature-propagation MLP takes its BN moments over the valid points
    it propagates to.
Module names follow the JAX variable paths (`sa_<i>.mlp_r<j>.mlp_<k>` /
`bn_<k>`, `fp_<i>.SharedMLP_0.*`), so the weight bridge maps them."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pointnet2 as pn2
from .layers import MaskedBatchNorm


class SharedMLP(nn.Module):
    """Per layer a Linear without bias, MaskedBatchNorm (the default eps)
    and ReLU over the last axis; moments over every other axis (the
    grouped neighbours of every query of the batch)."""

    def __init__(self, in_channels: int, channels):
        super().__init__()
        self.depth = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f'mlp_{i}', nn.Linear(in_channels, c, bias=False))
            setattr(self, f'bn_{i}', MaskedBatchNorm(c))
            in_channels = c

    def forward(self, x, mask=None, train: bool = False):
        for i in range(self.depth):
            x = getattr(self, f'bn_{i}')(getattr(self, f'mlp_{i}')(x),
                                         mask=mask,
                                         use_running_average=not train)
            x = F.relu(x)
        return x


def gather_points(x, idx):
    """x (B, N, ...) at idx (B, M) -> (B, M, ...)."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
                        .expand(*idx.shape, *x.shape[2:]))


class SetAbstractionMSG(nn.Module):
    """One SA level: FPS centres, then per radius a ball query, the grouped
    (xyz relative to the centre, features) rows through a SharedMLP and a
    max over the neighbours; the radii's outputs concatenated."""

    def __init__(self, in_channels: int, npoint: int, radii, nsamples,
                 mlps):
        super().__init__()
        self.npoint = int(npoint)
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(s) for s in nsamples)
        for i, mlp in enumerate(mlps):
            setattr(self, f'mlp_r{i}', SharedMLP(3 + in_channels, mlp))
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, features, mask, train: bool = False):
        """xyz (B, N, 3), features (B, N, C) or None, mask (B, N) ->
        (new_xyz (B, M, 3), features (B, M, out_channels), new_mask)."""
        fps_idx = pn2.farthest_point_sample(xyz, self.npoint, mask)
        new_xyz = gather_points(xyz, fps_idx)
        new_mask = gather_points(mask, fps_idx)
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii,
                                                  self.nsamples)):
            idx, empty = pn2.ball_query(radius, nsample, xyz, new_xyz, mask)
            grouped = pn2.group_points(xyz, idx) - new_xyz[:, :, None, :]
            if features is not None:
                grouped = torch.cat([grouped,
                                     pn2.group_points(features, idx)], -1)
            h = getattr(self, f'mlp_r{i}')(grouped, mask=None, train=train)
            h = torch.where(empty[..., None, None], 0.0, h)
            outs.append(h.amax(2))
        return new_xyz, torch.cat(outs, -1), new_mask


class FeaturePropagation(nn.Module):
    """FP level: inverse-distance interpolation of the coarser level's
    features at the 3 nearest valid centres, concatenated after the
    finer level's own features, through a SharedMLP whose BN counts the
    finer level's valid points."""

    def __init__(self, in_channels: int, mlp):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(in_channels, mlp)

    def forward(self, xyz_to, feats_to, mask_to, xyz_from, feats_from,
                mask_from, train: bool = False):
        dist, idx = pn2.three_nn(xyz_to, xyz_from, mask_from)
        up = pn2.three_interpolate(feats_from, idx, dist)
        h = up if feats_to is None else torch.cat([feats_to, up], -1)
        return self.SharedMLP_0(h, mask=mask_to, train=train)


class PointNet2MSG(nn.Module):
    """The SA / FP stack of BACKBONE_3D PointNet2MSG (SA_CONFIG NPOINTS,
    RADIUS, NSAMPLE, MLPS; FP_MLPS) on batched padded points."""

    def __init__(self, bb_cfg, num_point_features: int = 4):
        super().__init__()
        sa = bb_cfg.SA_CONFIG
        c_in = num_point_features - 3
        level_channels = [c_in]
        self.n_sa = len(sa.NPOINTS)
        for i in range(self.n_sa):
            mod = SetAbstractionMSG(c_in, sa.NPOINTS[i], sa.RADIUS[i],
                                    sa.NSAMPLE[i], sa.MLPS[i])
            setattr(self, f'sa_{i}', mod)
            c_in = mod.out_channels
            level_channels.append(c_in)
        fp_mlps = bb_cfg.FP_MLPS
        self.n_fp = len(fp_mlps)
        up = level_channels[-1]
        for i in range(self.n_fp - 1, -1, -1):
            setattr(self, f'fp_{i}', FeaturePropagation(
                level_channels[i] + up, fp_mlps[i]))
            up = int(fp_mlps[i][-1])
        self.num_point_features = up

    def forward(self, points, mask, train: bool = False):
        """points (B, N, 3 + C), mask (B, N) -> (B, N, FP_MLPS[0][-1])."""
        xyz = points[..., :3]
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        xyzs, featss, masks = [xyz], [feats], [mask]
        for i in range(self.n_sa):
            nx, nf, nm = getattr(self, f'sa_{i}')(xyzs[-1], featss[-1],
                                                 masks[-1], train)
            xyzs.append(nx)
            featss.append(nf)
            masks.append(nm)
        up = featss[-1]
        for i in range(self.n_fp - 1, -1, -1):
            up = getattr(self, f'fp_{i}')(xyzs[i], featss[i], masks[i],
                                          xyzs[i + 1], up, masks[i + 1],
                                          train)
        return up
