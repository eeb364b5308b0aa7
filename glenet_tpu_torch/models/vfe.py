"""Voxel feature encoders (torch counterpart of glenet_tpu/models/vfe.py):

  - MeanVFE: the mean of the raw point features in each voxel;
  - PillarVFE (PointPillars): a PointNet over each pillar's points with
    their offsets from the pillar's point mean and from the pillar's
    centre, max-pooled per pillar;
  - DynamicMeanVFE / DynamicPillarVFE: the same over every point of a voxel
    (no per-voxel cap), by segment reductions over the points' voxel slots
    (voxelize_dynamic) instead of a padded (V, P, C) table.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import scatter
from .layers import MaskedBatchNorm

# VFE names -> class, both spellings as glenet_tpu accepts them
DYNAMIC_MEAN = ('DynMeanVFE', 'DynamicMeanVFE')
DYNAMIC_PILLAR = ('DynPillarVFE', 'DynamicPillarVFE')


class MeanVFE(nn.Module):
    """voxels (..., V, P, C), num_points (..., V) -> (..., V, C): the mean of
    the raw point features in each voxel."""

    def forward(self, voxels, voxel_num_points):
        denom = voxel_num_points.to(voxels.dtype).clamp_min(1.0)
        return voxels.sum(dim=-2) / denom[..., None]


class PFNLayer(nn.Module):
    """Linear (no bias with the norm) -> MaskedBatchNorm over the valid
    points -> ReLU -> zero at padded points -> max over the pillar; all but
    the last layer concatenate the max back onto every point (half width
    each)."""

    def __init__(self, in_channels: int, features: int,
                 last_layer: bool = False, use_norm: bool = True):
        super().__init__()
        out = features if last_layer else features // 2
        self.last_layer, self.use_norm = last_layer, use_norm
        self.Dense_0 = nn.Linear(in_channels, out, bias=not use_norm)
        if use_norm:
            self.MaskedBatchNorm_0 = MaskedBatchNorm(out)

    def forward(self, x, point_mask, train: bool = False):
        """x (V, P, Cin), point_mask (V, P) -> (V, P, out) or (V, out)."""
        x = self.Dense_0(x)
        if self.use_norm:
            x = self.MaskedBatchNorm_0(x, mask=point_mask,
                                       use_running_average=not train)
        x = torch.where(point_mask[..., None], F.relu(x), 0.0)
        x_max = x.amax(dim=1)
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max[:, None].expand_as(x)], dim=-1)


class PillarVFE(nn.Module):
    """Features [xyz (or none), the other raw features, f_cluster (offset
    from the pillar's point mean), f_center (offset from the pillar's
    centre)] (+ |xyz| with_distance) -> PFNLayer_i.  Callers flatten the
    batch into the pillar axis, so the BN statistics span the batch."""

    def __init__(self, num_point_features: int, num_filters: Sequence[int],
                 voxel_size, point_cloud_range, use_absolute_xyz: bool = True,
                 with_distance: bool = False, use_norm: bool = True):
        super().__init__()
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in point_cloud_range)
        self.use_absolute_xyz = use_absolute_xyz
        self.with_distance = with_distance
        c = num_point_features + 6 if use_absolute_xyz \
            else num_point_features + 3
        c += int(with_distance)
        filters = list(num_filters)
        for i, f in enumerate(filters):
            setattr(self, f'PFNLayer_{i}', PFNLayer(
                c, f, last_layer=i == len(filters) - 1, use_norm=use_norm))
            c = f
        self.n_layers = len(filters)
        self.num_out_features = filters[-1]

    def forward(self, voxels, voxel_num_points, voxel_coords,
                train: bool = False):
        """voxels (V, P, C) raw point features, voxel_num_points (V,),
        voxel_coords (V, 3) as (z, y, x) -> (V, num_filters[-1])."""
        vx, vy, vz = self.voxel_size
        x0, y0, z0 = self.pc_range[:3]
        npts = voxel_num_points.to(voxels.dtype).clamp_min(1.0)
        xyz = voxels[:, :, :3]
        f_cluster = xyz - xyz.sum(dim=1, keepdim=True) / npts[:, None, None]
        c = voxel_coords.to(voxels.dtype)
        f_center = torch.stack([
            voxels[:, :, 0] - (c[:, 2:3] * vx + (vx / 2 + x0)),
            voxels[:, :, 1] - (c[:, 1:2] * vy + (vy / 2 + y0)),
            voxels[:, :, 2] - (c[:, 0:1] * vz + (vz / 2 + z0))], dim=-1)
        feats = [voxels if self.use_absolute_xyz else voxels[..., 3:],
                 f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=2, keepdim=True))
        features = torch.cat(feats, dim=-1)
        point_mask = (torch.arange(voxels.shape[1], device=voxels.device)[None]
                      < voxel_num_points[:, None])
        features = torch.where(point_mask[..., None], features, 0.0)
        for i in range(self.n_layers):
            features = getattr(self, f'PFNLayer_{i}')(features, point_mask,
                                                      train)
        return features


class DynamicMeanVFE(nn.Module):
    """points (N, C), point_voxel_idx (N,) slots (-1 dropped) -> (V, C): the
    mean of each voxel's points.  Callers flatten the batch into the point
    and slot axes."""

    def forward(self, points, point_voxel_idx, num_voxels: int):
        return scatter.segment_mean(points, point_voxel_idx, num_voxels)


class DynamicPillarVFE(nn.Module):
    """Scatter-based pillar encoder: per point [xyz (or none), the other
    features, offset from its pillar's point mean, offset from its pillar's
    centre] (+ |xyz| with_distance), then per layer `pfn_<i>` (Linear,
    without bias with the norm) -> `pfn_bn<i>` (MaskedBatchNorm over the
    valid points) -> ReLU -> the pillar's scatter-max, concatenated back
    onto each point between layers (glenet_tpu's widths: each layer has
    num_filters[i] outputs, so the next takes twice that).  Callers flatten
    the batch into the point and slot axes, so the BN moments span it."""

    def __init__(self, num_point_features: int, num_filters: Sequence[int],
                 voxel_size, point_cloud_range, use_absolute_xyz: bool = True,
                 with_distance: bool = False, use_norm: bool = True):
        super().__init__()
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in point_cloud_range)
        self.use_absolute_xyz = use_absolute_xyz
        self.with_distance = with_distance
        self.use_norm = use_norm
        c = num_point_features + (6 if use_absolute_xyz else 3)
        c += int(with_distance)
        filters = list(num_filters)
        for i, f in enumerate(filters):
            setattr(self, f'pfn_{i}', nn.Linear(c, f, bias=not use_norm))
            if use_norm:
                setattr(self, f'pfn_bn{i}', MaskedBatchNorm(f))
            c = 2 * f
        self.n_layers = len(filters)
        self.num_out_features = filters[-1]

    def forward(self, points, point_voxel_idx, voxel_coords,
                num_voxels: int, train: bool = False):
        """points (N, C), point_voxel_idx (N,), voxel_coords (V, 3) as
        (z, y, x) -> (V, num_filters[-1])."""
        vx, vy, vz = self.voxel_size
        x0, y0, z0 = self.pc_range[:3]
        valid = point_voxel_idx >= 0
        xyz = points[:, :3]
        mean_xyz = scatter.segment_mean(
            torch.where(valid[:, None], xyz, 0.0), point_voxel_idx,
            num_voxels)
        safe_idx = torch.where(valid, point_voxel_idx, 0).long()
        f_cluster = xyz - mean_xyz[safe_idx]
        c = voxel_coords.to(xyz.dtype)
        centers = torch.stack([c[:, 2] * vx + (vx / 2 + x0),
                               c[:, 1] * vy + (vy / 2 + y0),
                               c[:, 0] * vz + (vz / 2 + z0)], dim=1)
        f_center = xyz - centers[safe_idx]
        feats = [points if self.use_absolute_xyz else points[:, 3:],
                 f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=1, keepdim=True))
        x = torch.where(valid[:, None], torch.cat(feats, dim=-1), 0.0)
        for i in range(self.n_layers):
            x = getattr(self, f'pfn_{i}')(x)
            if self.use_norm:
                x = getattr(self, f'pfn_bn{i}')(
                    x, mask=valid, use_running_average=not train)
            x = torch.where(valid[:, None], F.relu(x), 0.0)
            x_max = scatter.segment_max(x, point_voxel_idx, num_voxels)
            if i == self.n_layers - 1:
                return x_max
            x = torch.where(valid[:, None],
                            torch.cat([x, x_max[safe_idx]], dim=-1), 0.0)
