"""Rotated BEV overlap, BEV IoU and 3D IoU (torch counterpart of
glenet_tpu/ops/iou3d.py).

The intersection of two convex quads is the convex hull of the 16 pairwise
edge-edge intersection points and the corners of each quad lying inside the
other (24 candidates with validity masks).  Candidates are sorted by angle
around the valid-point centroid, invalid tail slots are replaced by the
first vertex (duplicates add zero), and the shoelace sum gives the area.
Layout: (candidate, N) structure-of-arrays, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import trace

_EPS = 1e-8
_INSIDE_EPS = 1e-6


def box_to_bev_corners(boxes):
    """(..., 7) -> (..., 4, 2) BEV corners in CCW order."""
    template = torch.tensor([[1, 1], [-1, 1], [-1, -1], [1, -1]],
                            dtype=boxes.dtype, device=boxes.device) / 2.0
    trace.count('host_waits')           # a pageable host-to-device copy
    corners = boxes[..., None, 3:5] * template                 # (..., 4, 2)
    cosa = torch.cos(boxes[..., 6])[..., None]
    sina = torch.sin(boxes[..., 6])[..., None]
    x = corners[..., 0] * cosa - corners[..., 1] * sina
    y = corners[..., 0] * sina + corners[..., 1] * cosa
    return torch.stack([x, y], dim=-1) + boxes[..., None, 0:2]


def _overlap_soa(ax, ay, bx, by):
    """Overlap areas of N quad pairs; ax, ay, bx, by: (4, N) CCW corners."""
    ax1, ay1 = torch.roll(ax, -1, 0), torch.roll(ay, -1, 0)
    bx1, by1 = torch.roll(bx, -1, 0), torch.roll(by, -1, 0)
    cand_x, cand_y, cand_v = [], [], []

    # 16 edge-edge intersections
    for i in range(4):
        rx = ax1[i] - ax[i]
        ry = ay1[i] - ay[i]
        for j in range(4):
            sx = bx1[j] - bx[j]
            sy = by1[j] - by[j]
            denom = rx * sy - ry * sx
            qpx = bx[j] - ax[i]
            qpy = by[j] - ay[i]
            dsafe = torch.where(denom.abs() < _EPS, _EPS, denom)
            t = (qpx * sy - qpy * sx) / dsafe
            u = (qpx * ry - qpy * rx) / dsafe
            cand_x.append(ax[i] + t * rx)
            cand_y.append(ay[i] + t * ry)
            cand_v.append((denom.abs() > _EPS) & (t >= 0.0) & (t <= 1.0)
                          & (u >= 0.0) & (u <= 1.0))

    def inside(px, py, qx, qy, qx1, qy1):
        ins = None
        for e in range(4):
            ok = ((qx1[e] - qx[e]) * (py - qy[e])
                  - (qy1[e] - qy[e]) * (px - qx[e])) >= -_INSIDE_EPS
            ins = ok if ins is None else ins & ok
        return ins

    for i in range(4):
        cand_x.append(ax[i])
        cand_y.append(ay[i])
        cand_v.append(inside(ax[i], ay[i], bx, by, bx1, by1))
    for j in range(4):
        cand_x.append(bx[j])
        cand_y.append(by[j])
        cand_v.append(inside(bx[j], by[j], ax, ay, ax1, ay1))

    px = torch.stack(cand_x)                                    # (24, N)
    py = torch.stack(cand_y)
    v = torch.stack(cand_v)
    vf = v.to(px.dtype)
    count = vf.sum(0)
    denom_c = count.clamp_min(1.0)
    cx = (px * vf).sum(0) / denom_c
    cy = (py * vf).sum(0) / denom_c

    ang = torch.where(v, torch.atan2(py - cy, px - cx), 1e9)   # invalid last
    order = torch.sort(ang, dim=0, stable=True).indices
    px_s = px.gather(0, order)
    py_s = py.gather(0, order)

    # close the polygon: invalid tail slots -> copy of the first vertex
    live = torch.arange(px.shape[0], device=px.device,
                        dtype=count.dtype)[:, None] < count[None]
    px_s = torch.where(live, px_s, px_s[0][None])
    py_s = torch.where(live, py_s, py_s[0][None])
    x_n = torch.roll(px_s, -1, 0)
    y_n = torch.roll(py_s, -1, 0)
    area = 0.5 * (px_s * y_n - x_n * py_s).sum(0).abs()
    return torch.where(count >= 3, area, 0.0)


def overlap_bev_corners(ca, cb):
    """Overlap areas of row-aligned CCW quads: (..., 4, 2) x (..., 4, 2) ->
    (...)."""
    ca2, cb2 = ca.reshape(-1, 4, 2), cb.reshape(-1, 4, 2)
    return _overlap_soa(ca2[..., 0].T, ca2[..., 1].T, cb2[..., 0].T,
                        cb2[..., 1].T).reshape(ca.shape[:-2])


def _pairwise(corners_a, corners_b):
    """(N, 4, 2) x (M, 4, 2) -> (N, M) overlap areas."""
    n, m = corners_a.shape[0], corners_b.shape[0]

    def flat(c, a_side):
        c = c[:, None] if a_side else c[None]
        return c.expand(n, m, 4).reshape(n * m, 4).T            # (4, N*M)

    return _overlap_soa(flat(corners_a[..., 0], True),
                        flat(corners_a[..., 1], True),
                        flat(corners_b[..., 0], False),
                        flat(corners_b[..., 1], False)).reshape(n, m)


def boxes_overlap_bev(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) rotated BEV overlap areas."""
    return _pairwise(box_to_bev_corners(boxes_a), box_to_bev_corners(boxes_b))


def boxes_iou_bev(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) rotated BEV IoU."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / (area_a + area_b - overlap).clamp_min(1e-6)


def boxes_iou_bev_blocked(boxes_a, boxes_b, block_rows: int = 512):
    """Row-blocked (N, M) rotated BEV IoU: the same result as boxes_iou_bev
    with the polygon-clipping temporaries bounded to (block_rows, M)."""
    if boxes_a.shape[0] <= block_rows:
        return boxes_iou_bev(boxes_a, boxes_b)
    return torch.cat([boxes_iou_bev(blk, boxes_b)
                      for blk in boxes_a.split(block_rows)], dim=0)


def boxes_iou3d(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) 3D IoU: rotated BEV overlap times the
    z-extent overlap, over the union of the volumes."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_max = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    a_min = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    b_max = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    b_min = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    overlap_h = (torch.minimum(a_max, b_max)
                 - torch.maximum(a_min, b_min)).clamp_min(0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlap_3d / (vol_a + vol_b - overlap_3d).clamp_min(1e-6)


def boxes_aligned_iou3d(boxes_a, boxes_b):
    """3D IoU of row-aligned boxes: (N, 7) x (N, 7) -> (N,)."""
    overlap_bev = overlap_bev_corners(box_to_bev_corners(boxes_a),
                                      box_to_bev_corners(boxes_b))
    a_max = boxes_a[:, 2] + boxes_a[:, 5] / 2
    a_min = boxes_a[:, 2] - boxes_a[:, 5] / 2
    b_max = boxes_b[:, 2] + boxes_b[:, 5] / 2
    b_min = boxes_b[:, 2] - boxes_b[:, 5] / 2
    overlap_h = (torch.minimum(a_max, b_max)
                 - torch.maximum(a_min, b_min)).clamp_min(0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return overlap_3d / (vol_a + vol_b - overlap_3d).clamp_min(1e-6)


def boxes_bev_iou_np(boxes_a, boxes_b):
    """Rotated BEV IoU of host boxes, numpy in and out: (N, 7) x (M, 7) ->
    (N, M), computed in f32 on the CPU (the data pipeline's collision test
    stays on the host)."""
    a = torch.from_numpy(np.ascontiguousarray(boxes_a, np.float32))
    b = torch.from_numpy(np.ascontiguousarray(boxes_b, np.float32))
    return boxes_iou_bev(a, b).numpy()
