"""3D box corners, axis-aligned BEV IoU and points in boxes (torch
counterparts of glenet_tpu/utils/box_utils.py), and the numpy helpers of
the host data pipeline: range masks, points in boxes, KITTI camera <->
lidar boxes.

Box convention: (x, y, z, dx, dy, dz, heading), heading CCW about +z.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import common, trace

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
    trace.count('host_waits')           # the list index copied to the card
    return torch.cat([boxes3d[:, 0:2] - dims / 2, boxes3d[:, 0:2] + dims / 2],
                     dim=1)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """Approximate BEV IoU of target assignment: axis-aligned IoU of the
    nearest axis-aligned BEV boxes."""
    return boxes_iou_normal(boxes3d_lidar_to_aligned_bev_boxes(boxes_a),
                            boxes3d_lidar_to_aligned_bev_boxes(boxes_b))


# ---------------------------------------------------------------------------
# host-side numpy (data pipeline, data preparation, evaluation)
# ---------------------------------------------------------------------------

def points_in_boxes(points, boxes):
    """(..., N, 3+) points x (..., M, 7) boxes -> (..., N, M) bool: inside
    the rotated box, the z test |dz| <= dz / 2 about the box centre."""
    shift = points[..., :, None, :3] - boxes[..., None, :, 0:3]
    cosa = torch.cos(-boxes[..., 6])[..., None, :]
    sina = torch.sin(-boxes[..., 6])[..., None, :]
    local_x = shift[..., 0] * cosa - shift[..., 1] * sina
    local_y = shift[..., 0] * sina + shift[..., 1] * cosa
    return ((local_x.abs() <= boxes[..., None, :, 3] / 2)
            & (local_y.abs() <= boxes[..., None, :, 4] / 2)
            & (shift[..., 2].abs() <= boxes[..., None, :, 5] / 2))


def boxes_to_corners_3d_np(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) boxes -> (N, 8, 3) corners."""
    template = np.array(_CORNER_TEMPLATE, np.float32) / 2.0
    corners = boxes3d[:, None, 3:6] * template[None]
    corners = common.rotate_points_along_z_np(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def enlarge_box3d(boxes3d: np.ndarray, extra_width=(0, 0, 0)) -> np.ndarray:
    out = np.asarray(boxes3d).copy()
    out[:, 3:6] += np.asarray(extra_width, dtype=out.dtype)[None]
    return out


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1):
    """Keep boxes with >= min_num_corners corners inside limit_range."""
    if boxes.shape[1] > 7:
        boxes = boxes[:, :7]
    corners = boxes_to_corners_3d_np(boxes)  # (N, 8, 3)
    inside = ((corners >= np.asarray(limit_range[0:3])) &
              (corners <= np.asarray(limit_range[3:6]))).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners


def in_hull(p: np.ndarray, hull: np.ndarray) -> np.ndarray:
    from scipy.spatial import Delaunay
    if not isinstance(hull, Delaunay):
        hull = Delaunay(hull)
    return hull.find_simplex(p) >= 0


def points_in_boxes_np(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3) points x (M, 7) boxes -> (N, M) bool: inside the box, checked
    in its local frame (z within dz / 2)."""
    if boxes.shape[0] == 0 or points.shape[0] == 0:
        return np.zeros((points.shape[0], boxes.shape[0]), dtype=bool)
    shift = points[:, None, :3] - boxes[None, :, 0:3]          # (N, M, 3)
    cosa = np.cos(-boxes[:, 6])[None]
    sina = np.sin(-boxes[:, 6])[None]
    local_x = shift[..., 0] * cosa - shift[..., 1] * sina
    local_y = shift[..., 0] * sina + shift[..., 1] * cosa
    return ((np.abs(local_x) <= boxes[None, :, 3] / 2) &
            (np.abs(local_y) <= boxes[None, :, 4] / 2) &
            (np.abs(shift[..., 2]) <= boxes[None, :, 5] / 2))


def remove_points_in_boxes3d(points: np.ndarray,
                             boxes3d: np.ndarray) -> np.ndarray:
    mask = points_in_boxes_np(points[:, :3], boxes3d).any(axis=1)
    return points[~mask]


def boxes3d_kitti_camera_to_lidar(boxes3d_camera: np.ndarray, calib):
    """(N, 7) [x, y, z, l, h, w, ry] rect camera (bottom centre) -> (N, 7)
    lidar boxes (centre)."""
    xyz_camera = boxes3d_camera[:, 0:3]
    r = boxes3d_camera[:, 6:7]
    l, h, w = (boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5],
               boxes3d_camera[:, 5:6])
    xyz_lidar = calib.rect_to_lidar(xyz_camera).copy()
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar: np.ndarray, calib):
    """(N, 7) lidar boxes (centre) -> (N, 7) [x, y, z, l, h, w, ry] rect
    camera (bottom centre)."""
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    l, w, h = (boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5],
               boxes3d_lidar[:, 5:6])
    r = boxes3d_lidar[:, 6:7]
    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    r = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1)


def boxes3d_to_corners3d_kitti_camera(boxes3d: np.ndarray,
                                      bottom_center=True) -> np.ndarray:
    """(N, 7) camera boxes -> (N, 8, 3) corners (camera frame, y down)."""
    n = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_c = np.stack([l / 2, l / 2, -l / 2, -l / 2,
                    l / 2, l / 2, -l / 2, -l / 2], axis=1)
    z_c = np.stack([w / 2, -w / 2, -w / 2, w / 2,
                    w / 2, -w / 2, -w / 2, w / 2], axis=1)
    if bottom_center:
        y_c = np.zeros((n, 8), dtype=np.float32)
        y_c[:, 4:8] = -h[:, None]
    else:
        y_c = np.stack([h / 2] * 4 + [-h / 2] * 4, axis=1)
    ry = boxes3d[:, 6]
    zeros, ones = np.zeros(n, np.float32), np.ones(n, np.float32)
    rot = np.stack([
        np.cos(ry), zeros, -np.sin(ry),
        zeros, ones, zeros,
        np.sin(ry), zeros, np.cos(ry),
    ], axis=-1).reshape(n, 3, 3)
    corners = np.stack([x_c, y_c, z_c], axis=2) @ rot          # (N, 8, 3)
    return (corners + boxes3d[:, None, 0:3]).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d: np.ndarray, calib,
                                       image_shape=None) -> np.ndarray:
    """(N, 7) rect camera boxes -> (N, 4) [x1, y1, x2, y2] image boxes,
    clipped to the image when its shape is given."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners_img = pts_img.reshape(-1, 8, 2)
    boxes2d = np.concatenate([corners_img.min(axis=1),
                              corners_img.max(axis=1)], axis=1)
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], 0, image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], 0, image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], 0, image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], 0, image_shape[0] - 1)
    return boxes2d
