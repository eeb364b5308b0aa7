"""3D box corners (torch counterparts of glenet_tpu/utils/box_utils.py).

Box convention: (x, y, z, dx, dy, dz, heading), heading CCW about +z.
"""
from __future__ import annotations

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
