"""Voxel feature encoders (torch counterpart of glenet_tpu/models/vfe.py)."""
from __future__ import annotations

from torch import nn


class MeanVFE(nn.Module):
    """voxels (..., V, P, C), num_points (..., V) -> (..., V, C): the mean of
    the raw point features in each voxel."""

    def forward(self, voxels, voxel_num_points):
        denom = voxel_num_points.to(voxels.dtype).clamp_min(1.0)
        return voxels.sum(dim=-2) / denom[..., None]
