"""Core geometry helpers (torch counterparts of glenet_tpu/utils/common.py)."""
from __future__ import annotations

import math

import torch


def limit_period(val, offset: float = 0.5, period: float = 2 * math.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotation_matrix_z(angle):
    """(...,) angles -> (..., 3, 3) rotation matrices about +z (row-vector
    convention: points @ R)."""
    cosa = torch.cos(angle)
    sina = torch.sin(angle)
    zeros = torch.zeros_like(angle)
    ones = torch.ones_like(angle)
    rot = torch.stack([cosa, sina, zeros,
                       -sina, cosa, zeros,
                       zeros, zeros, ones], dim=-1)
    return rot.reshape(*angle.shape, 3, 3)


def rotate_points_along_z(points, angle):
    """Rotate points counter-clockwise about z.

    points: (B, N, 3 + C) or (N, 3 + C); angle: (B,) or scalar radians.
    """
    squeeze = points.dim() == 2
    if squeeze:
        points = points[None]
        angle = torch.as_tensor(angle, dtype=points.dtype,
                                device=points.device).reshape(1)
    rot = rotation_matrix_z(angle)                               # (B, 3, 3)
    xyz = torch.einsum('bnd,bde->bne', points[..., :3], rot)
    out = torch.cat([xyz, points[..., 3:]], dim=-1)
    return out[0] if squeeze else out
