"""PointRCNN's RoI refinement head (torch counterpart of
glenet_tpu/models/point_rcnn_head.py; reference pointrcnn_head.py):

  - each roi's pooled points (ops/roipoint_pool.py) carry [xyz, point
    score, point depth, backbone features], the xyz in the roi's canonical
    frame (`canonicalize_pooled`);
  - an MLP lifts the 5 prefix channels (XYZ_UP_LAYER), its output is
    concatenated with the backbone features and merged down;
  - single-scale-grouping set abstraction levels (SA_CONFIG; NPOINTS -1
    groups all) give one feature per roi;
  - CLS_FC / REG_FC stacks end in the class and box outputs.

USE_BN False (both published yamls; the detector refuses True) leaves BN
out of the XYZ_UP_LAYER, merge-down and SA layers (Linear with bias),
while the CLS_FC / REG_FC stacks always normalise in train mode over every
roi of the batch, without a mask (roi_head_template.py make_fc_layers).
Module names follow the JAX variable paths (`xyz_up.mlp_<i>`,
`merge_down`, `sa_<l>.mlp_<i>`, `cls_<i>` / `cls_bn<i>` / `cls_out`,
`reg_<i>` / `reg_bn<i>` / `reg_out`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pointnet2 as pn2
from ..utils import common
from . import roi_heads
from .layers import MaskedBatchNorm
from .pointnet2_backbone import gather_points

N_PREFIX = 5            # xyz, point score, point depth


class PlainMLP(nn.Module):
    """Linear (with bias) and ReLU per layer: the USE_BN False stack."""

    def __init__(self, in_channels: int, channels):
        super().__init__()
        self.depth = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f'mlp_{i}', nn.Linear(in_channels, c))
            in_channels = c

    def forward(self, x):
        for i in range(self.depth):
            x = F.relu(getattr(self, f'mlp_{i}')(x))
        return x


class SetAbstractionSSG(PlainMLP):
    """Single-scale-grouping SA level (PointnetSAModule) without BN: FPS
    centres, one ball query, grouped (xyz relative to the centre, features)
    through the MLP (PlainMLP), max over the neighbours, empty balls zeroed
    and masked out; with npoint None it groups all: every point (absolute
    xyz, features) through the MLP, invalid rows at -1e9 before the max, a
    roi without a valid point zeroed."""

    def __init__(self, in_channels: int, npoint, radius, nsample, mlp):
        super().__init__(3 + in_channels, mlp)
        self.npoint = npoint
        self.radius, self.nsample = radius, nsample
        self.out_channels = int(mlp[-1])

    def forward(self, xyz, features, mask):
        """xyz (N, S, 3), features (N, S, C), mask (N, S) -> (new_xyz (N,
        M, 3) or None, features (N, M, out_channels), new_mask (N, M))."""
        if self.npoint is None:
            h = super().forward(torch.cat([xyz, features], -1)[:, None])
            h = torch.where(mask[:, None, :, None], h, -1e9)
            new_mask = mask.any(1, keepdim=True)
            return None, torch.where(new_mask[..., None], h.amax(2),
                                     0.0), new_mask
        fps_idx = pn2.farthest_point_sample(xyz, self.npoint, mask)
        new_xyz = gather_points(xyz, fps_idx)
        new_mask = gather_points(mask, fps_idx)
        idx, empty = pn2.ball_query(self.radius, self.nsample, xyz, new_xyz,
                                    mask)
        grouped = torch.cat([pn2.group_points(xyz, idx)
                             - new_xyz[:, :, None, :],
                             pn2.group_points(features, idx)], -1)
        h = super().forward(grouped)
        h = torch.where(empty[..., None, None], 0.0, h)
        return new_xyz, h.amax(2), new_mask & ~empty


class PointRCNNHead(nn.Module):
    """ROI_HEAD PointRCNNHead: XYZ_UP_LAYER, CLS_FC, REG_FC, DP_RATIO,
    SA_CONFIG {NPOINTS, RADIUS, NSAMPLE, MLPS} (USE_BN False);
    `in_channels` the backbone's per-point features.  DP_RATIO dropout
    after the first layer of each FC stack in train mode
    (roi_heads.dropout, from the generator)."""

    def __init__(self, model_cfg, in_channels: int, num_class: int = 1,
                 code_size: int = 7):
        super().__init__()
        self.dp_ratio = float(model_cfg.get('DP_RATIO', 0.0))
        up = [int(c) for c in model_cfg.XYZ_UP_LAYER]
        self.xyz_up = PlainMLP(N_PREFIX, up)
        self.merge_down = nn.Linear(up[-1] + in_channels, up[-1])
        sa = model_cfg.SA_CONFIG
        c = up[-1]
        self.n_sa = len(sa.NPOINTS)
        for i in range(self.n_sa):
            npoint = None if int(sa.NPOINTS[i]) == -1 else int(sa.NPOINTS[i])
            mod = SetAbstractionSSG(c, npoint, float(sa.RADIUS[i]),
                                    int(sa.NSAMPLE[i]), sa.MLPS[i])
            setattr(self, f'sa_{i}', mod)
            c = mod.out_channels
        self.fc_depth = {}
        for name, key, out_ch in (('cls', 'CLS_FC', num_class),
                                  ('reg', 'REG_FC', code_size)):
            cin = c
            for i, s in enumerate(model_cfg[key]):
                setattr(self, f'{name}_{i}', nn.Linear(cin, s, bias=False))
                setattr(self, f'{name}_bn{i}', MaskedBatchNorm(s))
                cin = s
            self.fc_depth[name] = len(model_cfg[key])
            setattr(self, f'{name}_out', nn.Linear(cin, out_ch))
        nn.init.normal_(self.reg_out.weight, std=0.001)

    def _fc_stack(self, x, name, train, generator):
        for i in range(self.fc_depth[name]):
            x = F.relu(getattr(self, f'{name}_bn{i}')(
                getattr(self, f'{name}_{i}')(x),
                use_running_average=not train))
            if i == 0 and train and self.dp_ratio > 0:
                x = roi_heads.dropout(x, self.dp_ratio, generator)
        return getattr(self, f'{name}_out')(x)

    def forward(self, pooled, empty, train: bool = False, generator=None):
        """pooled (N, S, 5 + C): canonical pooled points [xyz, score,
        depth, features], zeroed for empty rois; empty (N,) -> rcnn_cls (N,
        num_class), rcnn_reg (N, code_size)."""
        feats = F.relu(self.merge_down(torch.cat(
            [self.xyz_up(pooled[..., :N_PREFIX]), pooled[..., N_PREFIX:]],
            -1)))
        xyz = pooled[..., :3]
        mask = ~empty[:, None].expand(xyz.shape[:2])
        for i in range(self.n_sa):
            xyz, feats, mask = getattr(self, f'sa_{i}')(xyz, feats, mask)
        shared = feats[:, 0]
        return {'rcnn_cls': self._fc_stack(shared, 'cls', train, generator),
                'rcnn_reg': self._fc_stack(shared, 'reg', train, generator)}


def pool_prefix_features(points_xyz, point_feats, point_scores,
                         depth_normalizer: float):
    """[score, depth / depth_normalizer - 0.5, features] per point
    (pointrcnn_head.py:106-115): points_xyz (..., N, 3), point_feats (...,
    N, C), point_scores (..., N) -> (..., N, 2 + C)."""
    depth = points_xyz.square().sum(-1).sqrt() / depth_normalizer - 0.5
    return torch.cat([point_scores[..., None], depth[..., None],
                      point_feats], -1)


def canonicalize_pooled(pooled, rois, empty):
    """Pooled xyz shifted to each roi's centre and rotated by -heading
    (pointrcnn_head.py:117-131); empty rois zeroed.  pooled (R, S, 3 + C),
    rois (R, 7), empty (R,)."""
    xyz = common.rotate_points_along_z(pooled[..., :3] - rois[:, None, 0:3],
                                       -rois[:, 6])
    out = torch.cat([xyz, pooled[..., 3:]], -1)
    return torch.where(empty[:, None, None], 0.0, out)
