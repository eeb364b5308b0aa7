"""Sparse 3D conv backbone VoxelBackBone8x on the gather-GEMM primitives of
ops/sparse.py (torch counterpart of glenet_tpu/models/spconv_backbone.py):

  conv_input SubM(16) -> conv1 [SubM16]
  -> conv2 [SpConv s2 -> 32, n2 x SubM32]            (sparse)
  -> conv3 [SpConv s2 -> 64, densify, n3 x SubM64]   (dense from level 3)
  -> conv4 [Conv s2 pad (0,1,1) -> 64, n4 x SubM64]  (dense)
  -> conv_out Conv (3,1,1) stride (2,1,1) -> C_out   (dense)
then HeightCompression to BEV (z folded into channels, z-outer).
VoxelBackBone8x has (n2, n3, n4) = (2, 2, 2) and C_out 128;
VoxelBackBone8xCiassd (GLENet-C) (2, 3, 3) and 64.

The dense levels keep NCDHW tensors and expose channels-last views, the
JAX package's layout, in `multi_scale`.  The level caps follow the voxel
budget of each call (the slot count of its input), so one set of
parameters serves the train budget and the test budget, as the JAX
package's two nets share theirs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sparse
from .layers import MaskedBatchNorm

# Compute dtype of the dense backbone levels (conv inputs and weights; BN
# runs in f32 on the conv output).  None keeps the input dtype.
DENSE_MXU_DTYPE = torch.bfloat16

# widths of the levels (the JAX module's default, used by every ported
# variant)
CHANNELS = (16, 32, 64, 64)


def _sparse_kernel(k_vol, cin, cout):
    return nn.Parameter(torch.randn(k_vol, cin, cout) / math.sqrt(k_vol * cin))


class SubMConvBN(nn.Module):
    """Submanifold sparse conv + BN + ReLU over an x-block (q, tbl) table,
    with the gather-only backward."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.kernel = _sparse_kernel(27, cin, features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)

    def forward(self, feats, nbr, mask, train: bool = False):
        out = sparse.subm_gather_gemm_xblocks_b(feats, nbr[0], nbr[1],
                                                self.kernel)
        out = self.MaskedBatchNorm_0(out, mask=mask,
                                     use_running_average=not train)
        return torch.where(mask[..., None], F.relu(out), 0.0)


class SparseConvBN(nn.Module):
    """Strided 3^3 sparse conv + BN + ReLU (changes the active-site table)."""

    def __init__(self, cin: int, features: int, stride, padding):
        super().__init__()
        self.kernel = _sparse_kernel(27, cin, features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
        self.stride, self.padding = stride, padding

    def forward(self, feats, ids, mask, grid, out_cap: int,
                train: bool = False):
        """Returns (out_feats, out_ids, out_mask, out_grid); at most
        `out_cap` output sites."""
        sites = [sparse.strided_output_sites(
            ids[i], mask[i], grid, 3, self.stride, self.padding, out_cap)
            for i in range(ids.shape[0])]
        out_ids = torch.stack([s[0] for s in sites])
        out_mask = torch.stack([s[1] for s in sites])
        q, tbl = sparse.strided_xblock_table_b(
            ids, mask, out_ids, out_mask, grid, self.stride, self.padding)
        out = sparse.gather_gemm_xblocks_b(feats, q, tbl, self.kernel)
        out = self.MaskedBatchNorm_0(out, mask=out_mask,
                                     use_running_average=not train)
        out = torch.where(out_mask[..., None], F.relu(out), 0.0)
        ogrid = sparse.out_grid_size(grid, 3, self.stride, self.padding)
        return out, out_ids, out_mask, ogrid


class DenseConvBN(nn.Module):
    """Masked dense 3D conv + BN + ReLU on NCDHW tensors: exact submanifold /
    strided sparse-conv semantics on a densified grid (zeros at inactive
    sites feed the conv; submanifold outputs are re-masked by occupancy)."""

    def __init__(self, cin: int, features: int, kernel_size=3, stride=1,
                 padding=1, submanifold: bool = True):
        super().__init__()
        self.kernel_size = sparse._as3(kernel_size)
        self.stride = sparse._as3(stride)
        self.padding = sparse._as3(padding)
        k_vol = math.prod(self.kernel_size)
        self.weight = nn.Parameter(
            torch.randn(features, cin, *self.kernel_size)
            / math.sqrt(k_vol * cin))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, channel_dim=1)
        self.submanifold = submanifold

    def forward(self, x, occ, train: bool = False):
        """x: (B, C, D, H, W); occ: (B, D, H, W) bool."""
        cdt = DENSE_MXU_DTYPE or x.dtype
        out = F.conv3d(x.to(cdt), self.weight.to(cdt), stride=self.stride,
                       padding=self.padding).float()
        if self.submanifold:
            new_occ = occ
        else:
            # any active input under the window
            new_occ = F.max_pool3d(occ[:, None].float(), self.kernel_size,
                                   self.stride, self.padding)[:, 0] > 0
        out = self.MaskedBatchNorm_0(out, mask=new_occ,
                                     use_running_average=not train)
        return torch.where(new_occ[:, None], F.relu(out), 0.0), new_occ


class VoxelBackBone8x(nn.Module):
    """grid_size: (nx, ny, nz) raw voxel grid; the sparse z becomes nz + 1.
    Levels 1-2 and conv3_down run sparse, the rest dense (dense_from=3)."""

    def __init__(self, grid_size, in_channels: int = 4,
                 subm_per_block=(2, 2, 2), out_channels: int = 128):
        super().__init__()
        self.grid_size = tuple(grid_size)
        c1, c2, c3, c4 = CHANNELS
        self.conv_input = SubMConvBN(in_channels, c1)
        self.conv1_0 = SubMConvBN(c1, c1)
        self.conv2_down = SparseConvBN(c1, c2, 2, 1)
        self.conv2 = [f'conv2_{j}' for j in range(subm_per_block[0])]
        for name in self.conv2:
            setattr(self, name, SubMConvBN(c2, c2))
        self.conv3_down = SparseConvBN(c2, c3, 2, 1)
        self.conv3 = [f'conv3_{j}' for j in range(subm_per_block[1])]
        for name in self.conv3:
            setattr(self, name, DenseConvBN(c3, c3))
        self.conv4_down = DenseConvBN(c3, c4, 3, 2, (0, 1, 1),
                                      submanifold=False)
        self.conv4 = [f'conv4_{j}' for j in range(subm_per_block[2])]
        for name in self.conv4:
            setattr(self, name, DenseConvBN(c4, c4))
        self.conv_out = DenseConvBN(c4, out_channels, (3, 1, 1), (2, 1, 1),
                                    (0, 0, 0), submanifold=False)
        self.level_channels = {'x_conv1': c1, 'x_conv2': c2, 'x_conv3': c3,
                               'x_conv4': c4}
        g = sparse.out_grid_size(self.sparse_grid, 3, 2, 1)
        g = sparse.out_grid_size(g, 3, 2, 1)
        g = sparse.out_grid_size(g, 3, 2, (0, 1, 1))
        g = sparse.out_grid_size(g, (3, 1, 1), (2, 1, 1), 0)
        self.num_bev_features = g[2] * out_channels

    @property
    def sparse_grid(self):
        nx, ny, nz = self.grid_size
        return (nx, ny, nz + 1)

    def forward(self, feats, coords, mask, train: bool = False):
        """feats (B, V, C), coords (B, V, 3) as (z, y, x) sorted by linear id
        within each sample, mask (B, V); V is the voxel budget, which sets
        the level caps.

        Returns dict: bev_features (B, ny8, nx8, C_bev) (a channels-last
        view), multi_scale {x_conv1..4} for the RoI stack.
        """
        grid1 = self.sparse_grid
        nx, ny, nz = grid1
        ids = torch.where(
            mask, coords[..., 0] * (ny * nx) + coords[..., 1] * nx
            + coords[..., 2], nx * ny * nz).to(torch.int32)
        caps = sparse.level_caps(feats.shape[1])
        ms = {}

        nbr1 = sparse.subm_xblock_table_b(ids, mask, grid1)
        x = self.conv_input(feats, nbr1, mask, train)
        x = self.conv1_0(x, nbr1, mask, train)
        ms['x_conv1'] = {'kind': 'sparse', 'features': x, 'ids': ids,
                         'mask': mask, 'grid': grid1, 'stride': 1}

        x, ids2, mask2, grid2 = self.conv2_down(x, ids, mask, grid1, caps[1],
                                                train)
        nbr2 = sparse.subm_xblock_table_b(ids2, mask2, grid2)
        for name in self.conv2:
            x = getattr(self, name)(x, nbr2, mask2, train)
        ms['x_conv2'] = {'kind': 'sparse', 'features': x, 'ids': ids2,
                         'mask': mask2, 'grid': grid2, 'stride': 2}

        x, ids3, mask3, grid3 = self.conv3_down(x, ids2, mask2, grid2,
                                                caps[2], train)
        xd, occ = sparse.to_dense_expand(x, ids3, mask3, grid3,
                                         DENSE_MXU_DTYPE)
        xd = xd.permute(0, 4, 1, 2, 3).contiguous()          # NCDHW
        for name in self.conv3:
            xd, occ = getattr(self, name)(xd, occ, train)
        ms['x_conv3'] = {'kind': 'dense',
                         'features': xd.permute(0, 2, 3, 4, 1), 'occ': occ,
                         'ids': ids3, 'mask': mask3, 'grid': grid3,
                         'stride': 4}

        xd, occ = self.conv4_down(xd, occ, train)
        for name in self.conv4:
            xd, occ = getattr(self, name)(xd, occ, train)
        grid4 = sparse.out_grid_size(grid3, 3, 2, (0, 1, 1))
        ms['x_conv4'] = {'kind': 'dense',
                         'features': xd.permute(0, 2, 3, 4, 1), 'occ': occ,
                         'grid': grid4, 'stride': 8}

        xd, occ = self.conv_out(xd, occ, train)
        # HeightCompression: fold z into channels, z-outer / channel-inner
        b, c, nz5, ny5, nx5 = xd.shape
        bev = xd.permute(0, 2, 1, 3, 4).reshape(b, nz5 * c, ny5, nx5)
        return {'bev_features': bev.permute(0, 2, 3, 1), 'multi_scale': ms,
                'num_bev_features': nz5 * c}


# BACKBONE_3D name -> (subm_per_block, out_channels)
VARIANTS = {'VoxelBackBone8x': ((2, 2, 2), 128),
            'VoxelBackBone8xCiassd': ((2, 3, 3), 64)}


def build_backbone_3d(bb3d_cfg, grid_size, in_channels=4):
    if bb3d_cfg.NAME in VARIANTS:
        subm, out_channels = VARIANTS[bb3d_cfg.NAME]
        return VoxelBackBone8x(grid_size=tuple(grid_size),
                               in_channels=in_channels, subm_per_block=subm,
                               out_channels=out_channels)
    raise NotImplementedError(f'BACKBONE_3D {bb3d_cfg.NAME} is not ported yet')
