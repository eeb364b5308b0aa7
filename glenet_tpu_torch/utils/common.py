"""Core geometry helpers (torch counterparts of glenet_tpu/utils/common.py),
the numpy mirrors the host data pipeline uses, and the CLIs' logger."""
from __future__ import annotations

import logging
import math

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the GPU when it is None.  A CUDA device that is not there
    raises: the port runs on the CPU only when the caller asks for it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run the '
                           'port on the CPU')
    return device


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


def limit_period_np(val, offset: float = 0.5, period: float = 2 * np.pi):
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z_np(points: np.ndarray, angle) -> np.ndarray:
    """Numpy mirror of rotate_points_along_z for the host data pipeline."""
    squeeze = points.ndim == 2
    if squeeze:
        points = points[None]
        angle = np.atleast_1d(angle)
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot = np.stack([
        cosa, sina, zeros,
        -sina, cosa, zeros,
        zeros, zeros, ones,
    ], axis=-1).reshape(-1, 3, 3)
    xyz = np.einsum('bnd,bde->bne', points[..., :3], rot)
    out = np.concatenate([xyz, points[..., 3:]], axis=-1)
    return out[0] if squeeze else out


def create_logger(log_file=None, rank: int = 0, log_level=None):
    """Console (and optional file) logger; ranks other than 0 log errors
    only."""
    log_level = log_level if log_level is not None else logging.INFO
    logger = logging.getLogger(__name__ + f'.rank{rank}')
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else logging.ERROR)
        console.setFormatter(formatter)
        logger.addHandler(console)
        if log_file is not None:
            fh = logging.FileHandler(log_file)
            fh.setLevel(log_level if rank == 0 else logging.ERROR)
            fh.setFormatter(formatter)
            logger.addHandler(fh)
    return logger
