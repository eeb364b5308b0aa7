"""RoI point pooling (torch counterpart of glenet_tpu/ops/roipoint_pool.py;
reference roipoint_pool3d CUDA extension), batched over B:

  - rois are enlarged by `extra_width` (dims grow, centres stay);
  - each roi takes the FIRST `num_sampled` in-box valid points in point
    order;
  - with fewer hits, slot k repeats hit k % count;
  - a roi with no hit pools zeros and is flagged empty.

The JAX package scatters every (roi, point) pair into a slot by its rank.
Here nothing is scattered: the running count of each roi's hits is sorted,
so the position of its (s + 1)-th hit is the first index where that count
reaches s + 1 (`torch.searchsorted`, as ops/pointnet2.ball_query finds
the first hits of a ball), which gives the same indices without a sync.
"""
from __future__ import annotations

import torch

from ..utils import box_utils


def roipoint_pool3d(points_xyz, point_features, rois, num_sampled: int,
                    extra_width=(0.0, 0.0, 0.0), points_mask=None):
    """points_xyz (B, P, 3), point_features (B, P, C), rois (B, R, 7),
    points_mask (B, P) -> (pooled (B, R, num_sampled, 3 + C) raw xyz and
    features (the canonical transform is the caller's), empty (B, R))."""
    grow = torch.zeros(7, dtype=rois.dtype, device=rois.device)
    grow[3:6] = torch.tensor(extra_width, dtype=rois.dtype)
    inbox = box_utils.points_in_boxes(points_xyz, rois[..., :7] + grow)
    if points_mask is not None:
        inbox &= points_mask[..., None]
    hits = inbox.transpose(1, 2).cumsum(-1, dtype=torch.int32).contiguous()
    count = hits[..., -1]
    b, r = count.shape
    rank = torch.arange(1, num_sampled + 1, dtype=torch.int32,
                        device=rois.device).expand(b, r, num_sampled)
    first = torch.searchsorted(hits, rank.contiguous())
    # slot k >= count reads hit k % count; an empty roi reads point 0
    k = torch.arange(num_sampled, device=rois.device)
    safe = count.clamp_min(1)[..., None].long()
    idx = torch.gather(first, -1, torch.where(k < safe, k, k % safe))
    empty = count == 0
    idx = torch.where(empty[..., None], 0, idx)
    feats = torch.cat([points_xyz, point_features], -1)
    pooled = torch.gather(feats, 1, idx.reshape(b, r * num_sampled, 1).expand(
        -1, -1, feats.shape[-1])).reshape(b, r, num_sampled, -1)
    return torch.where(empty[..., None, None], 0.0, pooled), empty
