"""3D box corners and axis-aligned BEV IoU (torch counterparts of
glenet_tpu/utils/box_utils.py).

Box convention: (x, y, z, dx, dy, dz, heading), heading CCW about +z.
"""
from __future__ import annotations

import math

import torch

from . import common

# index 0..3 bottom face, 4..7 top face
_CORNER_TEMPLATE = [
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
]


def _template(boxes):
    return torch.tensor(_CORNER_TEMPLATE, dtype=boxes.dtype,
                        device=boxes.device) / 2.0


def boxes_to_corners_3d(boxes3d):
    """(N, 7) boxes -> (N, 8, 3) corners."""
    corners = boxes3d[:, None, 3:6] * _template(boxes3d)[None]
    corners = common.rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def corners_bev(boxes):
    """(N, 7) -> (N, 4, 2) BEV corner rectangle, order (+x,+y), (+x,-y),
    (-x,-y), (-x,+y) in the box frame."""
    corners = boxes[:, None, 3:5] * _template(boxes)[None, :4, :2]
    cosa = torch.cos(boxes[:, 6])[:, None]
    sina = torch.sin(boxes[:, 6])[:, None]
    x = corners[..., 0] * cosa - corners[..., 1] * sina
    y = corners[..., 0] * sina + corners[..., 1] * cosa
    return torch.stack([x, y], dim=-1) + boxes[:, None, 0:2]


def boxes_iou_normal(boxes_a, boxes_b):
    """Axis-aligned 2D IoU of (N, 4) and (M, 4) [x1, y1, x2, y2] boxes ->
    (N, M)."""
    x_min = torch.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0])
    x_max = torch.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2])
    y_min = torch.maximum(boxes_a[:, None, 1], boxes_b[None, :, 1])
    y_max = torch.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3])
    inter = (x_max - x_min).clamp_min(0) * (y_max - y_min).clamp_min(0)
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    area_b = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(1e-6)


def boxes3d_lidar_to_aligned_bev_boxes(boxes3d):
    """(N, 7) rotated boxes -> (N, 4) nearest axis-aligned BEV boxes: the
    BEV extents swap when the heading is nearer +-pi/2 than 0 or pi."""
    rot = common.limit_period(boxes3d[:, 6], offset=0.5, period=math.pi).abs()
    dims = torch.where(rot[:, None] < math.pi / 4, boxes3d[:, 3:5],
                       boxes3d[:, [4, 3]])
    return torch.cat([boxes3d[:, 0:2] - dims / 2, boxes3d[:, 0:2] + dims / 2],
                     dim=1)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """Approximate BEV IoU of target assignment: axis-aligned IoU of the
    nearest axis-aligned BEV boxes."""
    return boxes_iou_normal(boxes3d_lidar_to_aligned_bev_boxes(boxes_a),
                            boxes3d_lidar_to_aligned_bev_boxes(boxes_b))
