"""BEV rectangle geometry of the augmentations (the part of
glenet_tpu/datasets/augmentor_utils.py that the port's host library's plain
collision test needs).  The other augmentations of that module are not
ported: `DataAugmentor` refuses their names."""
from __future__ import annotations

import numpy as np


def _bev_corners(boxes5):
    """(N, 5) [x, y, w, l, ry] -> (N, 4, 2) BEV corners."""
    x, y, w, l, ry = (boxes5[:, 0], boxes5[:, 1], boxes5[:, 2], boxes5[:, 3],
                      boxes5[:, 4])
    dx = np.stack([w / 2, w / 2, -w / 2, -w / 2], 1)
    dy = np.stack([l / 2, -l / 2, -l / 2, l / 2], 1)
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    cx = dx * c - dy * s + x[:, None]
    cy = dx * s + dy * c + y[:, None]
    return np.stack([cx, cy], axis=-1)


def _sat_overlap(corners_a, corners_b):
    """Exact convex-quad overlap by the separating axis theorem.

    corners_a: (A, 4, 2); corners_b: (B, 4, 2) -> (A, B) bool overlap."""
    def axes_of(c):
        e = np.roll(c, -1, axis=1) - c                       # (N, 4, 2)
        return np.stack([-e[..., 1], e[..., 0]], axis=-1)    # edge normals

    a = corners_a[:, None]                                   # (A, 1, 4, 2)
    b = corners_b[None]                                      # (1, B, 4, 2)
    sep = np.zeros((corners_a.shape[0], corners_b.shape[0]), bool)
    for axes in (axes_of(corners_a)[:, None],                # (A, 1, 4, 2)
                 axes_of(corners_b)[None]):                  # (1, B, 4, 2)
        # both quads' corners projected on each of the 4 axes:
        # (A, B, axis, corner)
        pa = (a[..., None, :, :] * axes[..., :, None, :]).sum(-1)
        pb = (b[..., None, :, :] * axes[..., :, None, :]).sum(-1)
        sep |= ((pa.max(-1) < pb.min(-1)) | (pb.max(-1) < pa.min(-1))).any(-1)
    return ~sep
