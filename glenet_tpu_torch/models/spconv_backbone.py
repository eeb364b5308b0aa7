"""Sparse 3D conv backbone VoxelBackBone8x on the gather-GEMM primitives of
ops/sparse.py (torch counterpart of glenet_tpu/models/spconv_backbone.py):

  conv_input SubM(16) -> conv1 [SubM16]
  -> conv2 [SpConv s2 -> 32, n2 x SubM32]            (sparse)
  -> conv3 [SpConv s2 -> 64, densify, n3 x SubM64]   (dense from level 3)
  -> conv4 [Conv s2 pad (0,1,1) -> 64, n4 x SubM64]  (dense)
  -> conv_out Conv (3,1,1) stride (2,1,1) -> C_out   (dense)
then HeightCompression to BEV (z folded into channels, z-outer).
VoxelBackBone8x has (n2, n3, n4) = (2, 2, 2) and C_out 128;
VoxelBackBone8xCiassd (GLENet-C) (2, 3, 3) and 64; VoxelResBackBone8x
(CenterPoint) (2, 2, 2), C_out 128 and level widths (16, 32, 64, 128), each
subm unit a residual SparseBasicBlock (`<name>a` conv-BN-ReLU, `<name>b`
conv-BN, the skip added, ReLU, masked; the dense levels the same on their
occupancy) and level 1 an extra `conv1_1`.

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

# widths of the levels (the JAX module's default; VoxelResBackBone8x has
# its own)
CHANNELS = (16, 32, 64, 64)


def _sparse_kernel(k_vol, cin, cout):
    return nn.Parameter(torch.randn(k_vol, cin, cout) / math.sqrt(k_vol * cin))


class SubMConvBN(nn.Module):
    """Submanifold sparse conv + BN (+ ReLU) over an x-block (q, tbl) table,
    with the gather-only backward."""

    def __init__(self, cin: int, features: int, use_relu: bool = True):
        super().__init__()
        self.kernel = _sparse_kernel(27, cin, features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
        self.use_relu = use_relu

    def forward(self, feats, nbr, mask, train: bool = False):
        out = sparse.subm_gather_gemm_xblocks_b(feats, nbr[0], nbr[1],
                                                self.kernel)
        out = self.MaskedBatchNorm_0(out, mask=mask,
                                     use_running_average=not train)
        if self.use_relu:
            out = F.relu(out)
        return torch.where(mask[..., None], out, 0.0)


class SparseConvBN(nn.Module):
    """Strided sparse conv + BN + ReLU (changes the active-site table).  A
    3^3 kernel runs over an x-block table; any other (UNetV2's (3, 1, 1)
    conv_out) over a row table."""

    def __init__(self, cin: int, features: int, stride, padding,
                 kernel_size=3):
        super().__init__()
        self.kernel_size = sparse._as3(kernel_size)
        self.kernel = _sparse_kernel(math.prod(self.kernel_size), cin,
                                     features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
        self.stride, self.padding = stride, padding

    def forward(self, feats, ids, mask, grid, out_cap: int,
                train: bool = False):
        """Returns (out_feats, out_ids, out_mask, out_grid); at most
        `out_cap` output sites."""
        ks, st, pad = self.kernel_size, self.stride, self.padding
        sites = [sparse.strided_output_sites(
            ids[i], mask[i], grid, ks, st, pad, out_cap)
            for i in range(ids.shape[0])]
        out_ids = torch.stack([s[0] for s in sites])
        out_mask = torch.stack([s[1] for s in sites])
        if ks == (3, 3, 3):
            q, tbl = sparse.strided_xblock_table_b(
                ids, mask, out_ids, out_mask, grid, st, pad)
            out = sparse.gather_gemm_xblocks_b(feats, q, tbl, self.kernel)
        else:
            table = torch.stack([sparse.strided_gather_table(
                ids[i], mask[i], out_ids[i], out_mask[i], grid, ks, st, pad)
                for i in range(ids.shape[0])])
            out = sparse.gather_gemm_b(feats, table, self.kernel)
        out = self.MaskedBatchNorm_0(out, mask=out_mask,
                                     use_running_average=not train)
        out = torch.where(out_mask[..., None], F.relu(out), 0.0)
        ogrid = sparse.out_grid_size(grid, ks, st, pad)
        return out, out_ids, out_mask, ogrid


class InverseConvBN(nn.Module):
    """Inverse sparse conv + BN + ReLU: coarse-level features gathered back
    onto the fine level's active sites (spconv SparseInverseConv3d with
    indice-key reuse)."""

    def __init__(self, cin: int, features: int, kernel_size, stride,
                 padding):
        super().__init__()
        self.kernel_size = sparse._as3(kernel_size)
        self.kernel = _sparse_kernel(math.prod(self.kernel_size), cin,
                                     features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
        self.stride, self.padding = stride, padding

    def forward(self, coarse_feats, coarse_ids, coarse_mask, fine_ids,
                fine_mask, fine_grid, train: bool = False):
        """-> (B, V_fine, C_out) features on the fine active set."""
        table = torch.stack([sparse.inverse_gather_table(
            fine_ids[i], fine_mask[i], coarse_ids[i], coarse_mask[i],
            fine_grid, self.kernel_size, self.stride, self.padding)
            for i in range(fine_ids.shape[0])])
        out = sparse.gather_gemm_b(coarse_feats, table, self.kernel)
        out = self.MaskedBatchNorm_0(out, mask=fine_mask,
                                     use_running_average=not train)
        return torch.where(fine_mask[..., None], F.relu(out), 0.0)


class DenseConvBN(nn.Module):
    """Masked dense 3D conv + BN + ReLU on NCDHW tensors: exact submanifold /
    strided sparse-conv semantics on a densified grid (zeros at inactive
    sites feed the conv; submanifold outputs are re-masked by occupancy)."""

    def __init__(self, cin: int, features: int, kernel_size=3, stride=1,
                 padding=1, submanifold: bool = True, use_relu: bool = True):
        super().__init__()
        self.use_relu = use_relu
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
        if self.use_relu:
            out = F.relu(out)
        return torch.where(new_occ[:, None], out, 0.0), new_occ


class VoxelBackBone8x(nn.Module):
    """grid_size: (nx, ny, nz) raw voxel grid; the sparse z becomes nz + 1.
    Levels 1-2 and conv3_down run sparse, the rest dense (dense_from=3).
    With `residual` each subm unit is a SparseBasicBlock (module
    docstring)."""

    def __init__(self, grid_size, in_channels: int = 4,
                 subm_per_block=(2, 2, 2), out_channels: int = 128,
                 site_lists: bool = False, channels=CHANNELS,
                 residual: bool = False):
        super().__init__()
        self.grid_size = tuple(grid_size)
        self.site_lists = site_lists
        self.residual = residual
        c1, c2, c3, c4 = channels
        self.conv_input = SubMConvBN(in_channels, c1)
        self.conv1 = self._units('conv1', 2 if residual else 1, c1,
                                 SubMConvBN)
        self.conv2_down = SparseConvBN(c1, c2, 2, 1)
        self.conv2 = self._units('conv2', subm_per_block[0], c2, SubMConvBN)
        self.conv3_down = SparseConvBN(c2, c3, 2, 1)
        self.conv3 = self._units('conv3', subm_per_block[1], c3, DenseConvBN)
        self.conv4_down = DenseConvBN(c3, c4, 3, 2, (0, 1, 1),
                                      submanifold=False)
        self.conv4 = self._units('conv4', subm_per_block[2], c4, DenseConvBN)
        self.conv_out = DenseConvBN(c4, out_channels, (3, 1, 1), (2, 1, 1),
                                    (0, 0, 0), submanifold=False)
        self.level_channels = {'x_conv1': c1, 'x_conv2': c2, 'x_conv3': c3,
                               'x_conv4': c4}
        g = sparse.out_grid_size(self.sparse_grid, 3, 2, 1)
        g = sparse.out_grid_size(g, 3, 2, 1)
        g = sparse.out_grid_size(g, 3, 2, (0, 1, 1))
        g = sparse.out_grid_size(g, (3, 1, 1), (2, 1, 1), 0)
        self.num_bev_features = g[2] * out_channels

    def _units(self, prefix, n, ch, cls):
        """The names of a level's n subm units, each a module (`<name>`) or
        with `residual` a pair (`<name>a`, `<name>b`, the second without
        its ReLU)."""
        names = [f'{prefix}_{j}' for j in range(n)]
        for name in names:
            if self.residual:
                setattr(self, f'{name}a', cls(ch, ch))
                setattr(self, f'{name}b', cls(ch, ch, use_relu=False))
            else:
                setattr(self, name, cls(ch, ch))
        return names

    def _subm(self, name, x, nbr, mask, train):
        if not self.residual:
            return getattr(self, name)(x, nbr, mask, train)
        h = getattr(self, f'{name}a')(x, nbr, mask, train)
        h = getattr(self, f'{name}b')(h, nbr, mask, train)
        return torch.where(mask[..., None], F.relu(h + x), 0.0)

    def _dense(self, name, x, occ, train):
        if not self.residual:
            return getattr(self, name)(x, occ, train)
        h, _ = getattr(self, f'{name}a')(x, occ, train)
        h, _ = getattr(self, f'{name}b')(h, occ, train)
        return torch.where(occ[:, None], F.relu(h + x), 0.0), occ

    @property
    def sparse_grid(self):
        nx, ny, nz = self.grid_size
        return (nx, ny, nz + 1)

    def forward(self, feats, coords, mask, train: bool = False):
        """feats (B, V, C), coords (B, V, 3) as (z, y, x) sorted by linear id
        within each sample, mask (B, V); V is the voxel budget, which sets
        the level caps.

        Returns dict: bev_features (B, ny8, nx8, C_bev) (a channels-last
        view), multi_scale {x_conv1..4} for the RoI stack (x_conv3 with its
        active-site list; x_conv4 with one when built with site_lists).
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
        for name in self.conv1:
            x = self._subm(name, x, nbr1, mask, train)
        ms['x_conv1'] = {'kind': 'sparse', 'features': x, 'ids': ids,
                         'mask': mask, 'grid': grid1, 'stride': 1}

        x, ids2, mask2, grid2 = self.conv2_down(x, ids, mask, grid1, caps[1],
                                                train)
        nbr2 = sparse.subm_xblock_table_b(ids2, mask2, grid2)
        for name in self.conv2:
            x = self._subm(name, x, nbr2, mask2, train)
        ms['x_conv2'] = {'kind': 'sparse', 'features': x, 'ids': ids2,
                         'mask': mask2, 'grid': grid2, 'stride': 2}

        x, ids3, mask3, grid3 = self.conv3_down(x, ids2, mask2, grid2,
                                                caps[2], train)
        xd, occ = sparse.to_dense_expand(x, ids3, mask3, grid3,
                                         DENSE_MXU_DTYPE)
        xd = xd.permute(0, 4, 1, 2, 3).contiguous()          # NCDHW
        for name in self.conv3:
            xd, occ = self._dense(name, xd, occ, train)
        ms['x_conv3'] = {'kind': 'dense',
                         'features': xd.permute(0, 2, 3, 4, 1), 'occ': occ,
                         'ids': ids3, 'mask': mask3, 'grid': grid3,
                         'stride': 4}

        xd, occ = self.conv4_down(xd, occ, train)
        for name in self.conv4:
            xd, occ = self._dense(name, xd, occ, train)
        grid4 = sparse.out_grid_size(grid3, 3, 2, (0, 1, 1))
        ms['x_conv4'] = {'kind': 'dense',
                         'features': xd.permute(0, 2, 3, 4, 1), 'occ': occ,
                         'grid': grid4, 'stride': 8}
        if self.site_lists:
            # the active sites of the stride-8 level by the spconv rule
            # conv4_down applies to occ, for the keypoint path (PV-RCNN)
            sites = [sparse.strided_output_sites(
                ids3[i], mask3[i], grid3, 3, 2, (0, 1, 1), caps[3])
                for i in range(ids3.shape[0])]
            ms['x_conv4'].update(ids=torch.stack([s[0] for s in sites]),
                                 mask=torch.stack([s[1] for s in sites]))

        xd, occ = self.conv_out(xd, occ, train)
        # HeightCompression: fold z into channels, z-outer / channel-inner
        b, c, nz5, ny5, nx5 = xd.shape
        bev = xd.permute(0, 2, 1, 3, 4).reshape(b, nz5 * c, ny5, nx5)
        return {'bev_features': bev.permute(0, 2, 3, 1), 'multi_scale': ms,
                'num_bev_features': nz5 * c}


class UNetV2(nn.Module):
    """Sparse-conv U-Net of PartA2 (reference spconv_unet.py:49-212): the
    VoxelBackBone8x encoder kept sparse at every level, the encoded
    (3, 1, 1) conv_out folded to BEV, and a decoder of UR blocks (lateral
    SparseBasicBlock, concat with the bottom-up stream, merge subm conv plus
    the channel-reduction residual, inverse sparse conv up one level).

    Outputs: bev_features, multi_scale (x_conv1..4, all sparse), and the
    per-voxel decoder features on the level-1 active set (point_features
    (B, V, 16), point_coords (B, V, 3) voxel centres, point_mask).
    """

    def __init__(self, grid_size, voxel_size, pc_range, in_channels: int = 4,
                 out_channels: int = 128):
        super().__init__()
        self.grid_size = tuple(grid_size)
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        c1, c2, c3, c4 = CHANNELS
        self.conv_input = SubMConvBN(in_channels, c1)
        self.conv1_0 = SubMConvBN(c1, c1)
        self.conv2_down = SparseConvBN(c1, c2, 2, 1)
        self.conv3_down = SparseConvBN(c2, c3, 2, 1)
        self.conv4_down = SparseConvBN(c3, c4, 2, (0, 1, 1))
        for lvl, ch in ((2, c2), (3, c3), (4, c4)):
            for j in range(2):
                setattr(self, f'conv{lvl}_{j}', SubMConvBN(ch, ch))
        self.conv_out = SparseConvBN(c4, out_channels, (2, 1, 1), 0,
                                     kernel_size=(3, 1, 1))
        # UR blocks (reference channel flow, spconv_unet.py:113-135): name,
        # lateral channels (the bottom stream's too, so the merge conv takes
        # twice them), out channels, the inverse conv's (channels, padding)
        # or None for the last level's subm conv
        for name, lat, out, inv in (('up4', c4, c4, (c4, (0, 1, 1))),
                                    ('up3', c3, c3, (c2, 1)),
                                    ('up2', c2, c2, (c1, 1)),
                                    ('up1', c1, c1, None)):
            setattr(self, f'{name}_t_c1', SubMConvBN(lat, lat))
            setattr(self, f'{name}_t_c2', SubMConvBN(lat, lat,
                                                      use_relu=False))
            setattr(self, f'{name}_m', SubMConvBN(2 * lat, out))
            if inv is None:
                setattr(self, f'{name}_inv', SubMConvBN(out, out))
            else:
                setattr(self, f'{name}_inv',
                        InverseConvBN(out, inv[0], 3, 2, inv[1]))
        self.level_channels = {'x_conv1': c1, 'x_conv2': c2, 'x_conv3': c3,
                               'x_conv4': c4}
        g = self.sparse_grid
        for stride, pad in ((2, 1), (2, 1), (2, (0, 1, 1))):
            g = sparse.out_grid_size(g, 3, stride, pad)
        g = sparse.out_grid_size(g, (3, 1, 1), (2, 1, 1), 0)
        self.num_bev_features = g[2] * out_channels

    @property
    def sparse_grid(self):
        nx, ny, nz = self.grid_size
        return (nx, ny, nz + 1)

    def encode(self, feats, coords, mask, train: bool = False):
        """The encoder and the BEV fold: (x_conv1..4 levels as
        (features, ids, mask, grid, nbr), bev_features, num_bev_features)."""
        grid1 = self.sparse_grid
        nx, ny, nz = grid1
        ids = torch.where(
            mask, coords[..., 0] * (ny * nx) + coords[..., 1] * nx
            + coords[..., 2], nx * ny * nz).to(torch.int32)
        caps = sparse.level_caps(feats.shape[1])
        nbr = sparse.subm_xblock_table_b(ids, mask, grid1)
        x = self.conv_input(feats, nbr, mask, train)
        x = self.conv1_0(x, nbr, mask, train)
        levels = [(x, ids, mask, grid1, nbr)]
        for lvl in (2, 3, 4):
            x, ids, mask, grid = getattr(self, f'conv{lvl}_down')(
                x, ids, mask, levels[-1][3], caps[lvl - 1], train)
            nbr = sparse.subm_xblock_table_b(ids, mask, grid)
            for j in range(2):
                x = getattr(self, f'conv{lvl}_{j}')(x, nbr, mask, train)
            levels.append((x, ids, mask, grid, nbr))
        xo, ids5, mask5, grid5 = self.conv_out(x, ids, mask, grid, caps[3],
                                               train)
        dense5 = torch.stack([sparse.to_dense(xo[i], ids5[i], mask5[i],
                                              grid5)
                              for i in range(xo.shape[0])])
        b, nz5, ny5, nx5, co = dense5.shape
        bev = dense5.permute(0, 2, 3, 1, 4).reshape(b, ny5, nx5, nz5 * co)
        return levels, bev, nz5 * co

    def _ur_block(self, name, lateral, bottom, nbr, mask, train, inv=None):
        """lateral SparseBasicBlock, merge conv + channel reduction (channel
        c * n_grp + g of the concat sums into c), then the inverse conv
        (inv = (coarse ids, coarse mask, fine ids, fine mask, fine grid))
        or, at the last level, a subm conv."""
        h = getattr(self, f'{name}_t_c1')(lateral, nbr, mask, train)
        h = getattr(self, f'{name}_t_c2')(h, nbr, mask, train)
        trans = torch.where(mask[..., None], F.relu(h + lateral), 0.0)
        cat = torch.cat([bottom, trans], dim=-1)
        merge = getattr(self, f'{name}_m')
        ch_out = merge.kernel.shape[-1]
        reduced = cat.reshape(*cat.shape[:-1], ch_out, -1).sum(-1)
        fused = merge(cat, nbr, mask, train) + reduced
        if inv is None:
            return getattr(self, f'{name}_inv')(fused, nbr, mask, train)
        return getattr(self, f'{name}_inv')(fused, *inv, train)

    def decode(self, levels, train: bool = False):
        """UR blocks from level 4 up to level 1 -> (B, V, 16)."""
        (x1, i1, m1, g1, n1), (x2, i2, m2, g2, n2), \
            (x3, i3, m3, g3, n3), (x4, i4, m4, g4, n4) = levels
        up = self._ur_block('up4', x4, x4, n4, m4, train,
                            (i4, m4, i3, m3, g3))
        up = self._ur_block('up3', x3, up, n3, m3, train,
                            (i3, m3, i2, m2, g2))
        up = self._ur_block('up2', x2, up, n2, m2, train,
                            (i2, m2, i1, m1, g1))
        return self._ur_block('up1', x1, up, n1, m1, train)

    def voxel_centres(self, ids, mask):
        """Metric centres (B, V, 3) of the level-1 sites, xyz."""
        z, y, x = sparse.delinearize(torch.where(mask, ids, 0).long(),
                                     self.sparse_grid)
        vs = torch.tensor(self.voxel_size, dtype=torch.float32,
                          device=ids.device)
        origin = torch.tensor(self.pc_range[:3], dtype=torch.float32,
                              device=ids.device)
        return (torch.stack([x, y, z], -1).float() + 0.5) * vs + origin

    def forward(self, feats, coords, mask, train: bool = False):
        """feats (B, V, C), coords (B, V, 3) (z, y, x) sorted by linear id
        within each sample, mask (B, V) -> dict as the class docstring."""
        levels, bev, n_bev = self.encode(feats, coords, mask, train)
        ms = {f'x_conv{i + 1}': {'kind': 'sparse', 'features': f, 'ids': ids,
                                  'mask': m, 'grid': g, 'stride': 2 ** i}
              for i, (f, ids, m, g, _) in enumerate(levels)}
        return {'bev_features': bev, 'multi_scale': ms,
                'num_bev_features': n_bev,
                'point_features': self.decode(levels, train),
                'point_coords': self.voxel_centres(levels[0][1], mask),
                'point_mask': mask}


# BACKBONE_3D name -> (subm_per_block, out_channels, level widths,
# residual)
VARIANTS = {'VoxelBackBone8x': ((2, 2, 2), 128, CHANNELS, False),
            'VoxelBackBone8xCiassd': ((2, 3, 3), 64, CHANNELS, False),
            'VoxelResBackBone8x': ((2, 2, 2), 128, (16, 32, 64, 128), True)}


def build_backbone_3d(bb3d_cfg, grid_size, in_channels=4,
                      site_lists: bool = False, voxel_size=None,
                      pc_range=None):
    """`site_lists` adds x_conv4's active-site list (ids, mask) to the
    outputs, which only the PV-RCNN keypoint path reads; UNetV2 needs the
    voxel size and range for its voxel centres."""
    if bb3d_cfg.NAME == 'UNetV2':
        return UNetV2(grid_size, voxel_size, pc_range, in_channels)
    if bb3d_cfg.NAME in VARIANTS:
        subm, out_channels, channels, residual = VARIANTS[bb3d_cfg.NAME]
        return VoxelBackBone8x(grid_size=tuple(grid_size),
                               in_channels=in_channels, subm_per_block=subm,
                               out_channels=out_channels,
                               site_lists=site_lists, channels=channels,
                               residual=residual)
    raise NotImplementedError(f'BACKBONE_3D {bb3d_cfg.NAME} is not ported yet')
