"""RoI refinement for the GLENet-VR predict path (torch counterpart of the
corner-mode, eval-mode part of glenet_tpu/models/roi_heads.py).

Each of the G^3 grid points of a roi aggregates the 8 ENCLOSING voxel
corners of each feature level: per corner h = mlp_in(feat) + mlp_pos(rel);
pooled = max over corners; mlp_out.  Corners come from a searchsorted lookup
on the sorted ids of sparse levels and from direct index math on dense
levels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import common
from .layers import MaskedBatchNorm

_CORNER_OFFS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def roi_grid_points(rois, grid_size: int):
    """(R, 7) rois -> (R, G^3, 3) global grid point coords; grid index
    order is row-major (d0, d1, d2)."""
    g = grid_size
    r = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(r, r, r, indexing='ij'),
                      dim=-1).reshape(-1, 3).to(torch.float32)
    sizes = rois[:, 3:6]
    local = (idx[None] + 0.5) / g * sizes[:, None] - sizes[:, None] / 2
    rotated = common.rotate_points_along_z(local, rois[:, 6])
    return rotated + rois[:, None, 0:3]


def _corner_cells(query_xyz, grid, stride, voxel_size, pc_range):
    """Integer (x, y, z) cells of the 8 corners around each query, their
    in-grid validity and metric centers relative to the query."""
    nx, ny, nz = grid
    dev = query_xyz.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    base = torch.floor((query_xyz - origin) / vs - 0.5).long()  # (..., 3)
    offs = torch.tensor(_CORNER_OFFS, device=dev)
    c = base[..., None, :] + offs                               # (..., 8, 3)
    cx, cy, cz = c.unbind(-1)
    valid = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
             & (cz >= 0) & (cz < nz))
    centers = (c.to(torch.float32) + 0.5) * vs + origin
    return cx, cy, cz, valid, centers - query_xyz[..., None, :]


def gather_corners_sparse(query_xyz, feats, ids, mask, grid, stride,
                          voxel_size, pc_range):
    """Corners from a sparse level, batched: query_xyz (B, Q, 3), feats
    (B, V, C), ids (B, V) sorted -> feats (B, Q, 8, C), rel (B, Q, 8, 3),
    valid (B, Q, 8)."""
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    b, v, c = feats.shape
    cx, cy, cz, valid, rel = _corner_cells(query_xyz, grid, stride,
                                           voxel_size, pc_range)
    tid = torch.where(valid, cz * (ny * nx) + cy * nx + cx, n_cells)
    flat_tid = tid.reshape(b, -1)
    pos = torch.searchsorted(ids.long(), flat_tid).clamp(0, v - 1)
    found = (ids.long().gather(1, pos) == flat_tid) & (flat_tid < n_cells)
    pos = torch.where(found, pos, v)
    padded = torch.cat([feats, feats.new_zeros((b, 1, c))], dim=1)
    cf = padded.gather(1, pos[..., None].expand(-1, -1, c))
    return (cf.reshape(*tid.shape, c), rel,
            found.reshape(tid.shape) & valid)


def gather_corners_dense(query_xyz, dense_feats, occ, grid, stride,
                         voxel_size, pc_range):
    """Corners from a dense level, batched: dense_feats (B, D, H, W, C) (may
    be a strided view), occ (B, D, H, W).  Out-of-grid corners read a
    clamped cell and are zeroed."""
    nx, ny, nz = grid
    b = dense_feats.shape[0]
    cx, cy, cz, valid, rel = _corner_cells(query_xyz, grid, stride,
                                           voxel_size, pc_range)
    bi = torch.arange(b, device=query_xyz.device).reshape(b, 1, 1)
    zi, yi, xi = cz.clamp(0, nz - 1), cy.clamp(0, ny - 1), cx.clamp(0, nx - 1)
    cf = torch.where(valid[..., None], dense_feats[bi, zi, yi, xi], 0.0)
    cv = occ[bi, zi, yi, xi] & valid
    return cf, rel, cv


class CornerAggregation(nn.Module):
    """Per-scale pooling: 8 enclosing voxel corners -> mlp_in + mlp_pos ->
    relu -> max -> mlp_out."""

    def __init__(self, cin: int, mlp_mid: int, mlp_out: int):
        super().__init__()
        self.mlp_in = nn.Linear(cin, mlp_mid, bias=False)
        self.bn_in = MaskedBatchNorm(mlp_mid)
        self.mlp_pos = nn.Linear(3, mlp_mid, bias=False)
        self.bn_pos = MaskedBatchNorm(mlp_mid)
        self.mlp_out = nn.Linear(mlp_mid, mlp_out, bias=False)
        self.bn_out = MaskedBatchNorm(mlp_out)

    def forward(self, corner_feats, rel_xyz, corner_valid, train=False):
        """corner_feats (Q, 8, C); rel_xyz (Q, 8, 3); corner_valid (Q, 8)."""
        ra = not train
        h = self.bn_in(self.mlp_in(corner_feats), mask=corner_valid,
                       use_running_average=ra)
        p = self.bn_pos(self.mlp_pos(rel_xyz), mask=corner_valid,
                        use_running_average=ra)
        h = torch.where(corner_valid[..., None], F.relu(h + p), 0.0)
        pooled = h.amax(dim=1)
        return F.relu(self.bn_out(self.mlp_out(pooled),
                                  use_running_average=ra))


class VoxelRCNNHead(nn.Module):
    """RoI refinement head (VoxelRCNNKLLabelIoUHead), corner pooling, with
    the KL-label branches (reg_std and the variance -> confidence scalar).
    Eval only: no dropout.

    level_channels: channels of each FEATURES_SOURCE level.
    """

    def __init__(self, model_cfg, voxel_size, pc_range, level_channels: dict,
                 code_size: int = 7):
        super().__init__()
        pool_cfg = model_cfg.ROI_GRID_POOL
        if str(pool_cfg.get('POOL_MODE', 'corner')) != 'corner':
            raise NotImplementedError('voxel_query RoI pooling is not ported '
                                      'yet')
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        self.sources = list(pool_cfg.FEATURES_SOURCE)
        self.grid = int(pool_cfg.GRID_SIZE)
        c_pooled = 0
        for src in self.sources:
            mid, out = pool_cfg.POOL_LAYERS[src]['MLPS'][0]
            setattr(self, f'pool_{src}',
                    CornerAggregation(level_channels[src], mid, out))
            c_pooled += out
        c = c_pooled * self.grid ** 3
        self.fc_names = {}
        for stack, key in (('shared', 'SHARED_FC'), ('cls_fc', 'CLS_FC'),
                           ('reg_fc', 'REG_FC')):
            c_in = c if stack == 'shared' else int(model_cfg.SHARED_FC[-1])
            names = []
            for i, s in enumerate(model_cfg[key]):
                # torch-default eps: the reference head FCs use BatchNorm1d
                bn = f'{stack}_bn{i}'
                setattr(self, f'{stack}_{i}', nn.Linear(c_in, s, bias=False))
                setattr(self, bn, MaskedBatchNorm(s, eps=1e-5))
                names.append((f'{stack}_{i}', bn))
                c_in = s
            self.fc_names[stack] = names
        c_cls = int(model_cfg.CLS_FC[-1])
        c_reg = int(model_cfg.REG_FC[-1])
        self.cls_pred = nn.Linear(c_cls, 1)
        self.reg_pred = nn.Linear(c_reg, code_size)
        nn.init.normal_(self.reg_pred.weight, std=0.001)
        # variance -> confidence: BN - ReLU - FC(64) - BN - ReLU - FC(1)
        self.reg_std = nn.Linear(c_reg, code_size)
        self.std_bn0 = MaskedBatchNorm(code_size, eps=1e-5)
        self.std_fc1 = nn.Linear(code_size, 64)
        self.std_bn1 = MaskedBatchNorm(64, eps=1e-5)
        self.std_fc2 = nn.Linear(64, 1)
        for lin in (self.reg_std, self.std_fc1, self.std_fc2):
            nn.init.normal_(lin.weight, std=0.0001)
            nn.init.zeros_(lin.bias)

    def _fc_stack(self, x, stack, train):
        for lin, bn in self.fc_names[stack]:
            x = F.relu(getattr(self, bn)(getattr(self, lin)(x),
                                         use_running_average=not train))
        return x

    def forward(self, rois, multi_scale, train: bool = False):
        """rois (B, R, 7) -> rcnn_cls (B*R, 1), rcnn_reg (B*R, C),
        rcnn_reg_std (B*R, C)."""
        if train:
            raise NotImplementedError('the train step is not ported yet')
        g = self.grid
        b, r = rois.shape[:2]
        grid_pts = roi_grid_points(rois.reshape(b * r, -1), g)
        grid_pts = grid_pts.reshape(b, r * g ** 3, 3)
        q = b * r * g ** 3
        pooled = []
        for src in self.sources:
            level = multi_scale[src]
            if level['kind'] == 'sparse':
                cf, rel, cv = gather_corners_sparse(
                    grid_pts, level['features'], level['ids'], level['mask'],
                    level['grid'], level['stride'], self.voxel_size,
                    self.pc_range)
            else:
                cf, rel, cv = gather_corners_dense(
                    grid_pts, level['features'], level['occ'], level['grid'],
                    level['stride'], self.voxel_size, self.pc_range)
            pooled.append(getattr(self, f'pool_{src}')(
                cf.reshape(q, 8, -1), rel.reshape(q, 8, 3), cv.reshape(q, 8)))
        feats = torch.cat(pooled, dim=-1).reshape(b * r, -1)

        shared = self._fc_stack(feats, 'shared', train)
        ori_cls = self.cls_pred(self._fc_stack(shared, 'cls_fc', train))
        reg_feat = self._fc_stack(shared, 'reg_fc', train)
        reg_std = self.reg_std(reg_feat)
        h = F.relu(self.std_bn0(reg_std))
        h = F.relu(self.std_bn1(self.std_fc1(h)))
        p = torch.sigmoid(ori_cls) * torch.sigmoid(self.std_fc2(h))
        return {'rcnn_cls': torch.log((p + 1e-6) / (1 - p + 1e-6)),
                'rcnn_reg': self.reg_pred(reg_feat), 'rcnn_reg_std': reg_std}


def decode_rcnn_boxes(rois, rcnn_reg, box_coder):
    """rois (B, R, 7), rcnn_reg (B*R, C) -> (B, R, 7) global boxes."""
    b, r = rois.shape[:2]
    flat_rois = rois.reshape(b * r, -1)
    local_rois = torch.cat([torch.zeros_like(flat_rois[:, :3]),
                            flat_rois[:, 3:]], dim=1)
    dec = box_coder.decode(rcnn_reg, local_rois[:, :box_coder.code_size])
    rotated = common.rotate_points_along_z(dec[:, None, :],
                                           flat_rois[:, 6])[:, 0]
    rotated = torch.cat([rotated[:, :3] + flat_rois[:, :3], rotated[:, 3:]],
                        dim=1)
    return rotated.reshape(b, r, -1)
