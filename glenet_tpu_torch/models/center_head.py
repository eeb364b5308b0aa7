"""CenterPoint's dense head (torch counterpart of
glenet_tpu/models/center_head.py): gaussian heatmap targets, the CenterNet
focal loss, the L1 box loss at the gt cells and the top-k decode.

The heatmap is the max over the gt boxes of each one's gaussian, taken per
class.  glenet_tpu forms the (M, C, H, W) product of every gt's map with
its one-hot class; here the gts go in chunks of at most HEATMAP_CHUNK
elements of (M, H, W) and a running per-class max keeps the result.  A
max is exact, so the map is glenet_tpu's (its peaks exactly 1 where the
gt's cell is, which the focal loss counts as positives; elsewhere torch's
and XLA's f32 exp may differ in the last bit) while its memory stays
bounded at the pillar configs' stride 1 (468 x 468 cells).

The decode flattens the heatmap in glenet_tpu's (H, W, C) order, class
fastest, and ranks by a stable descending sort, so among equal scores the
lower index comes first, as lax.top_k returns them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import distributed as dp

from .layers import MaskedBatchNorm

# elements of one chunk of per-gt gaussian maps (f32): 32 MiB
HEATMAP_CHUNK = 1 << 23

# the separate heads, their output channels, in glenet_tpu's order
HEADS = (('hm', None), ('center', 2), ('center_z', 1), ('dim', 3),
         ('rot', 2))


def _f32_reciprocal(v):
    return float(np.float32(1) / np.float32(v))


def gaussian_radius(dx, dy, min_overlap=0.5):
    """CenterNet's radius rule: the smallest of the three quadratic roots."""
    a1 = 1
    b1 = dx + dy
    c1 = dx * dy * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * a1 * c1).clamp_min(0))) / 2
    a2 = 4
    b2 = 2 * (dx + dy)
    c2 = (1 - min_overlap) * dx * dy
    r2 = (b2 + torch.sqrt((b2 ** 2 - 4 * a2 * c2).clamp_min(0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (dx + dy)
    c3 = (min_overlap - 1) * dx * dy
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp_min(0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def assign_targets_single(gt_boxes, gt_mask, num_classes, feature_map_size,
                          feature_map_stride, voxel_size, pc_range,
                          gaussian_overlap=0.1, min_radius=2):
    """One sample: gt_boxes (M, 8) with 1-based classes, gt_mask (M,) ->
    heatmap (C, H, W), target boxes (M, 8) [x, y offsets in the cell, z,
    log dims, cos, sin], flat cell indices y * W + x (M,) int32, and the
    valid mask (M,) int32.  feature_map_size is (W, H) = (x, y)."""
    w, h = feature_map_size
    dev = gt_boxes.device
    x, y, z = gt_boxes[:, 0], gt_boxes[:, 1], gt_boxes[:, 2]
    # glenet_tpu divides by the voxel size and the stride; its compiled
    # graph multiplies by their f32 reciprocals (XLA's rewrite of a division
    # by a constant), which moves a cell coordinate by an ulp: the products
    # here keep the cells and offsets equal to the compiled ones
    inv_x, inv_y = (_f32_reciprocal(voxel_size[i]) for i in (0, 1))
    inv_s = _f32_reciprocal(feature_map_stride)
    coord_x = ((x - pc_range[0]) * inv_x * inv_s).clamp(0, w - 0.5)
    coord_y = ((y - pc_range[1]) * inv_y * inv_s).clamp(0, h - 0.5)
    # truncations, as glenet_tpu's int32 casts
    center_x = coord_x.to(torch.int32)
    center_y = coord_y.to(torch.int32)
    dxf = gt_boxes[:, 3] * inv_x * inv_s
    dyf = gt_boxes[:, 4] * inv_y * inv_s
    radius = gaussian_radius(dxf, dyf, gaussian_overlap).to(
        torch.int32).clamp_min(min_radius).float()
    valid = gt_mask & (dxf > 0) & (dyf > 0)

    cxf = center_x.float()[:, None, None]
    cyf = center_y.float()[:, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    denom = (2 * (radius / 3.0).clamp_min(1e-3) ** 2)[:, None, None]
    cls_ids = gt_boxes[:, 7].to(torch.int32) - 1
    heatmap = gt_boxes.new_zeros((num_classes, h, w))
    m = gt_boxes.shape[0]
    chunk = max(1, HEATMAP_CHUNK // (h * w))
    for s in range(0, m, chunk):
        sl = slice(s, min(s + chunk, m))
        d2 = (xs - cxf[sl]) ** 2 + (ys - cyf[sl]) ** 2
        g = torch.exp(-d2 / denom[sl])
        r = radius[sl, None, None]
        within = (((xs - cxf[sl]).abs() <= r) & ((ys - cyf[sl]).abs() <= r)
                  & valid[sl, None, None])
        g = torch.where(within, g, 0.0)
        for c in range(num_classes):
            heatmap[c] = torch.maximum(heatmap[c], torch.where(
                (cls_ids[sl] == c)[:, None, None], g, 0.0).amax(0))

    inds = center_y * w + center_x
    target = torch.cat([
        (coord_x - center_x.float())[:, None],
        (coord_y - center_y.float())[:, None],
        z[:, None],
        torch.log(gt_boxes[:, 3:6].clamp_min(1e-5)),
        torch.cos(gt_boxes[:, 6])[:, None],
        torch.sin(gt_boxes[:, 6])[:, None]], dim=1)
    return heatmap, target, inds, valid.to(torch.int32)


class CenterHead(nn.Module):
    """Single-group CenterPoint head (every class in one heatmap): a shared
    3x3 conv (`Conv_0`, with a bias when use_bias_before_norm) -> BN ->
    ReLU, then per branch `<name>_0` 3x3 conv -> `<name>_bn0` BN -> ReLU ->
    `<name>_1` biased 3x3 conv; the heatmap's bias starts at -2.19 (the
    focal prior), every other bias at 0, as flax initialises them.  Input
    and outputs are channels-last (B, H, W, C) views."""

    def __init__(self, in_channels: int, num_class: int, shared_ch: int = 64,
                 use_bias_before_norm: bool = False):
        super().__init__()
        self.num_class = num_class
        self.Conv_0 = nn.Conv2d(in_channels, shared_ch, 3, padding=1,
                                bias=use_bias_before_norm)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(shared_ch, channel_dim=1)
        for name, out in HEADS:
            out = num_class if out is None else out
            setattr(self, f'{name}_0', nn.Conv2d(
                shared_ch, shared_ch, 3, padding=1,
                bias=use_bias_before_norm))
            setattr(self, f'{name}_bn0',
                    MaskedBatchNorm(shared_ch, channel_dim=1))
            setattr(self, f'{name}_1', nn.Conv2d(shared_ch, out, 3,
                                                 padding=1))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Conv2d) and mod.bias is not None:
                    mod.bias.zero_()
            self.hm_1.bias.fill_(-2.19)

    def forward(self, x, train: bool = False):
        x = x.permute(0, 3, 1, 2)
        h = F.relu(self.MaskedBatchNorm_0(self.Conv_0(x),
                                          use_running_average=not train))
        out = {}
        for name, _ in HEADS:
            y = getattr(self, f'{name}_0')(h)
            y = F.relu(getattr(self, f'{name}_bn0')(
                y, use_running_average=not train))
            out[name] = getattr(self, f'{name}_1')(y).permute(0, 2, 3, 1)
        return out


def centernet_focal_loss(pred_hm, gt_hm):
    """CenterNet's focal loss over logits pred_hm and the gaussian targets,
    normalised by the positives (cells where the target is exactly 1)."""
    pred = torch.sigmoid(pred_hm).clamp(1e-4, 1 - 1e-4)
    pos = (gt_hm == 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - gt_hm, 4)
    pos_loss = -torch.log(pred) * torch.pow(1 - pred, 2) * pos
    neg_loss = (-torch.log(1 - pred) * torch.pow(pred, 2) * neg_weights
                * (1 - pos))
    return (pos_loss.sum() + neg_loss.sum()) / dp.global_count(
        pos.sum()).clamp_min(1.0)


def center_reg_loss(pred_maps, target_boxes, inds, mask):
    """L1 at the gt cells, every code summed (glenet_tpu ignores
    code_weights here): pred_maps (B, H, W, 8) [center, center_z, dim,
    rot], target_boxes (B, M, 8), inds (B, M) flat y * W + x, mask (B, M)
    -> the sum over valid gts divided by their count (at least 1)."""
    b, h, w, c = pred_maps.shape
    gathered = torch.gather(pred_maps.reshape(b, h * w, c), 1,
                            inds.long()[..., None].expand(-1, -1, c))
    diff = (gathered - target_boxes).abs() * mask[..., None]
    return diff.sum() / dp.global_count(mask.sum()).clamp_min(1.0)


def decode_center_boxes(out, k, voxel_size, pc_range, feature_map_stride,
                        score_thresh=0.0):
    """Top-k decode of the head's maps (B, H, W, C): the k best cells over
    every class (sigmoid scores, ties to the lower (H, W, C)-flat index),
    boxes [x, y, z, dx, dy, dz, heading] from the cell, its sub-cell offset
    and the regressed maps.  Returns boxes (B, k, 7), scores (B, k) zeroed
    below score_thresh, labels (B, k) from 1."""
    hm = torch.sigmoid(out['hm'])
    b, h, w, c = hm.shape
    k = min(k, h * w * c)
    scores, idx = torch.sort(hm.reshape(b, h * w * c), dim=1,
                             descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    cls_id = idx % c
    spatial = idx // c
    ys = (spatial // w).float()
    xs = (spatial % w).float()

    def gather_map(m):
        return torch.gather(m.reshape(b, h * w, m.shape[-1]), 1,
                            spatial[..., None].expand(-1, -1, m.shape[-1]))

    center = gather_map(out['center'])
    center_z = gather_map(out['center_z'])
    dim = torch.exp(gather_map(out['dim']))
    rot = gather_map(out['rot'])
    angle = torch.atan2(rot[..., 1], rot[..., 0])
    x = ((xs + center[..., 0]) * feature_map_stride * voxel_size[0]
         + pc_range[0])
    y = ((ys + center[..., 1]) * feature_map_stride * voxel_size[1]
         + pc_range[1])
    boxes = torch.stack([x, y, center_z[..., 0], dim[..., 0], dim[..., 1],
                         dim[..., 2], angle], dim=-1)
    scores = torch.where(scores >= score_thresh, scores, 0.0)
    return boxes, scores, cls_id + 1
