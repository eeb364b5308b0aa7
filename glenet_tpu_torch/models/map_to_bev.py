"""Pillar features -> dense BEV canvas (torch counterpart of
PointPillarScatter in glenet_tpu/models/map_to_bev.py)."""
from __future__ import annotations

import torch
from torch import nn


class PointPillarScatter(nn.Module):
    """Writes each valid pillar's features at its (y, x) cell of a zero
    (B, ny, nx, C) canvas, the channels-last layout BaseBEVBackbone takes;
    invalid pillars are dropped, not written."""

    def __init__(self, grid_size):
        super().__init__()
        self.nx, self.ny, nz = (int(g) for g in grid_size)
        if nz != 1:
            raise ValueError(f'PointPillarScatter needs nz == 1, got {nz}')

    def forward(self, pillar_features, voxel_coords, voxel_mask):
        """pillar_features (B, V, C), voxel_coords (B, V, 3) as (z, y, x),
        voxel_mask (B, V) -> (B, ny, nx, C)."""
        b, v, c = pillar_features.shape
        cells = self.ny * self.nx
        flat = voxel_coords[..., 1].long() * self.nx + voxel_coords[..., 2]
        # invalid pillars go to one dump row per sample, dropped below
        flat = torch.where(voxel_mask, flat, cells)
        flat = flat + torch.arange(b, device=flat.device)[:, None] * (cells + 1)
        feats = torch.where(voxel_mask[..., None], pillar_features, 0.0)
        canvas = pillar_features.new_zeros((b * (cells + 1), c)).index_copy(
            0, flat.reshape(-1), feats.reshape(b * v, c))
        return canvas.reshape(b, cells + 1, c)[:, :cells].reshape(
            b, self.ny, self.nx, c)
