"""RoI-aware voxel pooling (torch counterpart of
glenet_tpu/ops/roiaware_pool.py; reference roiaware_pool3d CUDA extension):
per-point features pooled into a fixed (G, G, G) voxel grid inside each
rotated roi, max or avg per cell.

Every point is moved into every roi's canonical frame and the (roi, point)
pairs that fall inside a roi get their cell (`roi_cells`).  Only those pairs
are pooled, by one index_reduce (max) or index_add (avg) over the R * G^3
cells (`pool_cells`): the JAX package scatters every pair, the ones outside
into a dump cell, which costs R * P rows where a point lies in a few rois.
Finding the pairs takes one device-to-host sync per call.  Both reductions
carry gradients as the JAX package's scatters do: a max splits its cotangent
evenly among the points tied at the cell's maximum; empty cells are 0.
"""
from __future__ import annotations

import warnings

import torch

from ..utils import common

_NEG = -1e9


def roi_cells(points_xyz, rois, out_size: int, points_mask=None):
    """One sample's in-roi (roi, point) pairs in row-major order: points_xyz
    (P, 3), rois (R, 7) -> (point index (N,), flat cell r * G^3 + (x * G + y)
    * G + z (N,)), the grid axes ordered (x, y, z)."""
    g = out_size
    shifted = points_xyz[None, :, :] - rois[:, None, 0:3]
    local = common.rotate_points_along_z(shifted, -rois[:, 6])  # (R, P, 3)
    dims = rois[:, None, 3:6]
    inbox = (local.abs() < dims / 2 + 1e-5).all(dim=-1)
    if points_mask is not None:
        inbox = inbox & points_mask[None, :]
    r_idx, p_idx = inbox.nonzero(as_tuple=True)
    local, dims = local[r_idx, p_idx], dims[r_idx, 0]
    cell = torch.floor((local + dims / 2) / (dims / g)).long().clamp(0, g - 1)
    flat = (cell[:, 0] * g * g + cell[:, 1] * g + cell[:, 2]) + r_idx * g ** 3
    return p_idx, flat


def pool_cells(point_features, p_idx, flat, n_rois: int, out_size: int,
               method: str = 'max'):
    """Pool point_features (P, C) of the pairs of roi_cells into (R, G, G, G,
    C): the max of each cell's points, or their mean; 0 where empty."""
    g, c = out_size, point_features.shape[1]
    n = n_rois * g ** 3
    vals = point_features[p_idx]
    if method == 'max':
        acc = point_features.new_full((n, c), _NEG)
        with warnings.catch_warnings():      # index_reduce is a beta API
            warnings.simplefilter('ignore', UserWarning)
            acc = acc.index_reduce(0, flat, vals, 'amax', include_self=True)
        pooled = torch.where(acc > _NEG / 2, acc, 0.0)
    elif method == 'avg':
        acc = point_features.new_zeros((n, c)).index_add(0, flat, vals)
        cnt = point_features.new_zeros((n, 1)).index_add(
            0, flat, point_features.new_ones((flat.shape[0], 1)))
        pooled = acc / cnt.clamp_min(1.0)
    else:
        raise ValueError(method)
    return pooled.reshape(n_rois, g, g, g, c)


def roiaware_pool3d(points_xyz, point_features, rois, out_size: int,
                    method: str = 'max', points_mask=None):
    """One sample: points_xyz (P, 3), point_features (P, C), rois (R, 7),
    method 'max' | 'avg', points_mask (P,) -> pooled (R, G, G, G, C), the
    grid axes ordered (x, y, z) as the reference kernel lays them out;
    empty cells are 0."""
    if method not in ('max', 'avg'):
        raise ValueError(method)
    p_idx, flat = roi_cells(points_xyz, rois, out_size, points_mask)
    return pool_cells(point_features, p_idx, flat, rois.shape[0], out_size,
                      method)
