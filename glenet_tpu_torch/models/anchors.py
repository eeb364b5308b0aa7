"""Anchor grid generation (static, computed once at model build, numpy) —
the port's own copy of glenet_tpu/models/anchors.py.

Per class the anchors live on an (H, W, num_sizes, num_rots, 7) grid (H = y,
W = x); classes are concatenated on the anchor axis to (H, W, A_total, 7)
and flattened row-major, the ordering of head conv outputs reshaped from
(H, W, A_total * C).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AnchorSet:
    """All anchors for one feature map + per-class metadata."""
    anchors: np.ndarray            # (H, W, A_total, 7) float32
    flat_anchors: np.ndarray       # (H * W * A_total, 7)
    num_anchors_per_location: int  # A_total
    class_names: list              # len == num classes
    class_slices: list             # per-class slice into the anchor axis
    matched_thresholds: dict       # class_name -> float
    unmatched_thresholds: dict     # class_name -> float
    feature_map_size: tuple        # (H, W)


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range,
                     anchor_ndim: int = 7) -> AnchorSet:
    """Args:
        anchor_generator_cfg: list of per-class dicts with keys
            class_name, anchor_sizes, anchor_rotations, anchor_bottom_heights,
            feature_map_stride, matched_threshold, unmatched_threshold,
            optional align_center.
        grid_size: (nx, ny, nz) voxel grid
        point_cloud_range: (x0, y0, z0, x1, y1, z1)
    """
    pc_range = np.asarray(point_cloud_range, np.float64)
    strides = {cfg['feature_map_stride'] for cfg in anchor_generator_cfg}
    if len(strides) != 1:
        raise ValueError('one shared feature map assumed')
    stride = strides.pop()
    nx = int(grid_size[0]) // stride
    ny = int(grid_size[1]) // stride

    per_class = []
    class_names, class_slices = [], []
    matched, unmatched = {}, {}
    offset = 0
    for cfg in anchor_generator_cfg:
        sizes = np.asarray(cfg['anchor_sizes'], np.float64)       # (S, 3)
        rots = np.asarray(cfg['anchor_rotations'], np.float64)    # (R,)
        heights = np.asarray(cfg['anchor_bottom_heights'], np.float64)  # (Z,)
        if len(heights) != 1:
            raise ValueError('single bottom height supported')
        align_center = cfg.get('align_center', False)
        if align_center:
            x_stride = (pc_range[3] - pc_range[0]) / nx
            y_stride = (pc_range[4] - pc_range[1]) / ny
            x_off, y_off = x_stride / 2, y_stride / 2
        else:
            x_stride = (pc_range[3] - pc_range[0]) / (nx - 1)
            y_stride = (pc_range[4] - pc_range[1]) / (ny - 1)
            x_off = y_off = 0.0
        xs = pc_range[0] + x_off + x_stride * np.arange(nx)
        ys = pc_range[1] + y_off + y_stride * np.arange(ny)

        s, r = len(sizes), len(rots)
        a = np.zeros((ny, nx, s, r, 7), np.float64)
        a[..., 0] = xs[None, :, None, None]
        a[..., 1] = ys[:, None, None, None]
        a[..., 2] = heights[0] + sizes[None, None, :, None, 2] / 2  # center z
        a[..., 3:6] = sizes[None, None, :, None, :]
        a[..., 6] = rots[None, None, None, :]
        a = a.reshape(ny, nx, s * r, 7)
        per_class.append(a)
        class_names.append(cfg['class_name'])
        class_slices.append(slice(offset, offset + s * r))
        offset += s * r
        matched[cfg['class_name']] = float(cfg['matched_threshold'])
        unmatched[cfg['class_name']] = float(cfg['unmatched_threshold'])

    anchors = np.concatenate(per_class, axis=2).astype(np.float32)
    return AnchorSet(
        anchors=anchors,
        flat_anchors=anchors.reshape(-1, 7),
        num_anchors_per_location=offset,
        class_names=class_names,
        class_slices=class_slices,
        matched_thresholds=matched,
        unmatched_thresholds=unmatched,
        feature_map_size=(ny, nx),
    )
