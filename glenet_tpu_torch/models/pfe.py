"""Point-feature extraction of PV-RCNN and PV-RCNN++ (torch counterpart of
glenet_tpu/models/pfe.py): VoxelSetAbstraction keypoints, their
foreground head PointHeadSimple and its loss.

  - NUM_KEYPOINTS keypoints by farthest-point sampling of the raw points
    (SAMPLE_METHOD FPS), or with SPC (PV-RCNN++'s sectorized
    proposal-centric sampling) of those near a RoI;
  - per keypoint, features from each FEATURES_SOURCE: 'bev' by bilinear
    interpolation of the HeightCompression map (stride 8), 'raw_points' and
    'x_conv1..4' by StackSAModuleMSG (ball query, shared MLP, max pool per
    radius) or VectorPoolAggregationMSG (models/vector_pool.py) over the raw
    cloud or a backbone level's voxel centres, with FILTER_NEIGHBOR_WITH_ROI
    only over the points near a RoI;
  - the concatenation (bev, raw_points, then the levels in FEATURES_SOURCE
    order) -> Linear without bias, BN, ReLU to NUM_OUTPUT_FEATURES.

Everything is batched over B with fixed keypoint and neighbour counts.  The
dense backbone levels keep their active-site lists (ids, mask) beside the
dense tensor, and their rows are gathered at those ids.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pointnet2 as pn2
from ..ops import sparse
from . import point_heads, vector_pool
from .layers import MaskedBatchNorm
from .pointnet2_backbone import SharedMLP
from .vector_pool import VectorPoolAggregationMSG


def bilinear_interpolate(im, x, y):
    """im (H, W, C), x (N,), y (N,) pixel coordinates -> (N, C).  The corner
    indices are clamped to the map but the weights come from the unclamped
    corners (clamp-to-edge, as the reference's voxel_set_abstraction)."""
    h, w = im.shape[:2]
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = x0 + 1, y0 + 1
    x0c, x1c = x0.clamp(0, w - 1), x1.clamp(0, w - 1)
    y0c, y1c = y0.clamp(0, h - 1), y1.clamp(0, h - 1)
    wa = (x1 - x) * (y1 - y)
    wb = (x1 - x) * (y - y0)
    wc = (x - x0) * (y1 - y)
    wd = (x - x0) * (y - y0)
    return (im[y0c, x0c] * wa[:, None] + im[y1c, x0c] * wb[:, None]
            + im[y0c, x1c] * wc[:, None] + im[y1c, x1c] * wd[:, None])


class StackSAModuleMSG(nn.Module):
    """Aggregation from one point source at query points: per radius, a
    ball query, the neighbours' offsets to the query concatenated with
    their features, SharedMLP `mlp_r<i>` (BN moments over every neighbour
    of every query, empty balls' rows of index 0 included), zeros for empty
    balls, max over the neighbours; the radii concatenated."""

    def __init__(self, in_channels: int, radii, nsamples, mlps):
        super().__init__()
        self.radii = [float(r) for r in radii]
        self.nsamples = [int(n) for n in nsamples]
        for i, m in enumerate(mlps):
            setattr(self, f'mlp_r{i}', SharedMLP(3 + in_channels, list(m)))
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, query_xyz, src_xyz, src_feats, src_mask,
                train: bool = False):
        """query_xyz (B, M, 3); src_xyz (B, N, 3); src_feats (B, N, C) or
        None; src_mask (B, N) or None (all valid) -> (B, M, out_channels)."""
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            idx, empty = pn2.ball_query(radius, nsample, src_xyz, query_xyz,
                                        src_mask)
            grouped = (pn2.group_points(src_xyz, idx)
                       - query_xyz[:, :, None, :])
            if src_feats is not None:
                grouped = torch.cat(
                    [grouped, pn2.group_points(src_feats, idx)], -1)
            h = getattr(self, f'mlp_r{i}')(grouped, train=train)
            h = torch.where(empty[..., None, None], 0.0, h)
            # amax spreads the gradient evenly over tied neighbours (the
            # repeated first hit), as JAX's max does
            outs.append(h.amax(2))
        return torch.cat(outs, -1)


def sparse_level_points(level, voxel_size, pc_range):
    """A backbone level as a point cloud: voxel centres (B, N, 3), features
    (B, N, C) and mask (B, N) of its active sites.  Sparse levels carry
    their feature rows; dense levels (a channels-last view (B, D, H, W, C))
    give the rows at the sites' z-y-x linear ids, zeros at masked slots."""
    ids, mask = level['ids'], level['mask']
    safe = torch.where(mask, ids, 0).long()
    z, y, x = sparse.delinearize(safe, level['grid'])
    vs = torch.tensor(voxel_size, dtype=torch.float32,
                      device=ids.device) * level['stride']
    origin = torch.tensor(pc_range[:3], dtype=torch.float32,
                          device=ids.device)
    xyz = (torch.stack([x, y, z], -1).float() + 0.5) * vs + origin
    if level['kind'] == 'sparse':
        return xyz, level['features'], mask
    dense = level['features'].permute(0, 4, 1, 2, 3)          # (B, C, D, H, W)
    b, c = dense.shape[:2]
    flat = dense.reshape(b, c, -1)
    rows = flat.gather(2, safe[:, None, :].expand(b, c, safe.shape[1]))
    return xyz, torch.where(mask[..., None], rows.transpose(1, 2), 0.0), mask


class VoxelSetAbstraction(nn.Module):
    """PV-RCNN's and PV-RCNN++'s keypoint features (see the module
    docstring).

    num_bev_features: channels of the HeightCompression map;
    num_point_features: of the raw points (xyz first);
    level_channels: {x_conv<i>: channels} of the backbone levels."""

    def __init__(self, model_cfg, voxel_size, pc_range, num_bev_features: int,
                 num_point_features: int, level_channels: dict):
        super().__init__()
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        self.num_keypoints = int(model_cfg.NUM_KEYPOINTS)
        method = model_cfg.get('SAMPLE_METHOD', 'FPS')
        if method not in ('FPS', 'SPC'):
            raise NotImplementedError(f'SAMPLE_METHOD {method}')
        self.spc_radius = (float(model_cfg.SPC_SAMPLING
                                 .SAMPLE_RADIUS_WITH_ROI)
                           if method == 'SPC' else None)
        self.sources = list(model_cfg.FEATURES_SOURCE)
        sa_cfg = model_cfg.SA_LAYER
        c_in = num_bev_features if 'bev' in self.sources else 0
        self.levels = [s for s in self.sources
                       if s not in ('bev', 'raw_points')]
        src_channels = dict(level_channels,
                            raw_points=num_point_features - 3)
        # source -> (module name, RADIUS_OF_NEIGHBOR_WITH_ROI or None)
        self.aggregators = {}
        for src in (['raw_points'] if 'raw_points' in self.sources else []) \
                + self.levels:
            cfg_s = sa_cfg[src]
            if cfg_s.get('NAME', '') == 'VectorPoolAggregationModuleMSG':
                # a source without features gets a column of ones
                name = f'vp_{src}'
                mod = VectorPoolAggregationMSG(cfg_s,
                                               src_channels[src] or 1)
            else:
                name = f'sa_{src}'
                mod = StackSAModuleMSG(src_channels[src], cfg_s.POOL_RADIUS,
                                       cfg_s.NSAMPLE, cfg_s.MLPS)
            setattr(self, name, mod)
            self.aggregators[src] = (name, float(
                cfg_s.RADIUS_OF_NEIGHBOR_WITH_ROI)
                if cfg_s.get('FILTER_NEIGHBOR_WITH_ROI', False) else None)
            c_in += mod.out_channels
        self.needs_rois = self.spc_radius is not None or any(
            r is not None for _, r in self.aggregators.values())
        self.num_features_before_fusion = c_in
        c_out = int(model_cfg.NUM_OUTPUT_FEATURES)
        self.fusion = nn.Linear(c_in, c_out, bias=False)
        self.fusion_bn = MaskedBatchNorm(c_out)

    def keypoints(self, points, points_mask, rois=None, roi_valid=None):
        """(B, K, 3) keypoints by FPS over the valid raw points; with
        SAMPLE_METHOD SPC over those within SAMPLE_RADIUS_WITH_ROI of a valid
        roi (sample_points_with_roi_mask), or over all valid points in a
        scene where none is.  Like glenet_tpu, one masked FPS over the scene
        (NUM_SECTORS is not read)."""
        xyz = points[..., :3]
        fps_mask = points_mask
        if self.spc_radius is not None:
            near = vector_pool.sample_points_with_roi_mask(
                xyz, points_mask, rois[..., :7], roi_valid, self.spc_radius)
            fps_mask = torch.where(near.any(-1, keepdim=True), near,
                                   points_mask)
        idx = pn2.farthest_point_sample(xyz, self.num_keypoints, fps_mask)
        return xyz.gather(1, idx[..., None].expand(*idx.shape, 3)), idx

    def aggregate(self, src, kp, xyz, feats, mask, rois, roi_valid, train):
        """One source's keypoint features: its support mask cut to the
        points within RADIUS_OF_NEIGHBOR_WITH_ROI of a valid roi where
        FILTER_NEIGHBOR_WITH_ROI is set, then StackSAModuleMSG (`sa_<src>`)
        or VectorPoolAggregationMSG (`vp_<src>`)."""
        name, radius = self.aggregators[src]
        if radius is not None:
            mask = vector_pool.sample_points_with_roi_mask(
                xyz, mask, rois[..., :7], roi_valid, radius)
        mod = getattr(self, name)
        if name.startswith('vp_'):
            if feats is None:
                feats = xyz.new_ones((*xyz.shape[:2], 1))
            return mod(xyz, mask, feats, kp, train)
        return mod(kp, xyz, feats, mask, train)

    def forward(self, points, points_mask, multi_scale, bev_features,
                bev_stride: int = 8, rois=None, roi_valid=None,
                train: bool = False):
        """points (B, P, 3 + F) raw, points_mask (B, P), multi_scale the
        backbone's levels, bev_features (B, H, W, C); rois (B, R, 7+) and
        roi_valid (B, R) for SPC keypoints and the roi-filtered sources.
        Returns keypoints (B, K, 3), keypoint_idx (B, K), point_features
        (B, K, C_out) and point_features_before_fusion (B, K, C_in)."""
        kp, kp_idx = self.keypoints(points, points_mask, rois, roi_valid)
        feats = []
        if 'bev' in self.sources:
            vx, vy = self.voxel_size[0], self.voxel_size[1]
            x0, y0 = self.pc_range[0], self.pc_range[1]
            xi = (kp[..., 0] - x0) / vx / bev_stride
            yi = (kp[..., 1] - y0) / vy / bev_stride
            feats.append(torch.stack([
                bilinear_interpolate(bev_features[i], xi[i], yi[i])
                for i in range(kp.shape[0])]))
        if 'raw_points' in self.sources:
            raw = points[..., 3:] if points.shape[-1] > 3 else None
            feats.append(self.aggregate('raw_points', kp, points[..., :3],
                                        raw, points_mask, rois, roi_valid,
                                        train))
        for src in self.levels:
            xyz, f, m = sparse_level_points(multi_scale[src], self.voxel_size,
                                            self.pc_range)
            feats.append(self.aggregate(src, kp, xyz, f, m, rois, roi_valid,
                                        train))
        before = torch.cat(feats, -1)
        h = self.fusion_bn(self.fusion(before), use_running_average=not train)
        return {'keypoints': kp, 'keypoint_idx': kp_idx,
                'point_features': F.relu(h),
                'point_features_before_fusion': before}


def assign_keypoint_seg_targets(kp_xyz, gt_boxes, gt_mask,
                                extra_width=(0.2, 0.2, 0.2)):
    """Class-agnostic keypoint labels: 1 inside a gt box, -1 in its shell
    enlarged by `extra_width`, 0 elsewhere.  kp_xyz (..., K, 3), gt_boxes
    (..., M, 8), gt_mask (..., M) -> (..., K) int64."""
    _, is_fg, is_ignore = point_heads.box_membership(
        kp_xyz, torch.ones(kp_xyz.shape[:-1], dtype=torch.bool,
                           device=kp_xyz.device),
        gt_boxes, gt_mask, extra_width)
    return torch.where(is_ignore, -1, is_fg.long())


def keypoint_seg_loss(cls_preds, cls_labels, num_class: int = 1):
    """Sigmoid focal loss over the keypoints of the whole batch, normalised
    by max(#foreground, 1); label -1 is ignored.  cls_preds (N, num_class),
    cls_labels (N,)."""
    return point_heads.focal_cls_loss(cls_preds, cls_labels.long(),
                                      num_class)


class PointHeadSimple(nn.Module):
    """Keypoint foreground head: per CLS_FC entry a Linear without bias,
    BN and ReLU, then `cls_out` (Linear with bias) to num_class logits."""

    def __init__(self, in_channels: int, num_class: int = 1,
                 cls_fc=(256, 256)):
        super().__init__()
        self.depth = len(cls_fc)
        for i, c in enumerate(cls_fc):
            setattr(self, f'cls_{i}', nn.Linear(in_channels, c, bias=False))
            setattr(self, f'cls_bn{i}', MaskedBatchNorm(c))
            in_channels = c
        self.cls_out = nn.Linear(in_channels, num_class)

    def forward(self, feats, train: bool = False):
        x = feats
        for i in range(self.depth):
            x = F.relu(getattr(self, f'cls_bn{i}')(
                getattr(self, f'cls_{i}')(x), use_running_average=not train))
        return self.cls_out(x)
