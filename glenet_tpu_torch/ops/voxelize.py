"""Static-shape voxelization on the device (torch counterpart of
glenet_tpu/ops/voxelize.py).

Contract:
  - points outside `point_cloud_range` are dropped,
  - at most `max_points_per_voxel` points kept per voxel (in input order),
  - at most `max_voxels` voxels kept, chosen by the first point index that
    touched each voxel (first-come priority),
  - voxel slots are ordered by linear voxel id; coords are (z, y, x), -1 pad.

`voxelize_dynamic` chooses the same voxels but gives each point its slot
instead of a per-voxel point table (the dynamic VFEs).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import trace

_I32_MAX = 2 ** 31 - 1


def _select_voxels_first_occurrence(vid_sorted, sort_idx, n_cells: int,
                                    max_voxels: int):
    """Up to max_voxels occupied voxel ids, prioritized by the FIRST original
    point index that touched each voxel; returned sorted ascending,
    sentinel-padded to (max_voxels,)."""
    n = vid_sorted.shape[0]
    dev = vid_sorted.device
    first_of_run = torch.ones(n, dtype=torch.bool, device=dev)
    first_of_run[1:] = vid_sorted[1:] != vid_sorted[:-1]
    run_id = torch.cumsum(first_of_run.long(), 0) - 1
    # segment minima; segments no point falls in keep the int32 max
    init = torch.full((n,), _I32_MAX, dtype=torch.int64, device=dev)
    first_occ = init.scatter_reduce(0, run_id, sort_idx, 'amin',
                                    include_self=False)
    run_vid = init.scatter_reduce(0, run_id, vid_sorted, 'amin',
                                  include_self=False)
    valid_run = run_vid < n_cells
    priority = torch.where(valid_run, first_occ, n)
    order = torch.argsort(priority, stable=True)[:max_voxels]
    chosen = torch.where(valid_run[order], run_vid[order], n_cells)
    if trace.enabled():     # occupied voxels against the budget
        trace.count('voxels_offered', valid_run)
        trace.count('voxels_kept', chosen < n_cells)
    if chosen.shape[0] < max_voxels:        # fewer points than voxel slots
        chosen = torch.cat([chosen, torch.full(
            (max_voxels - chosen.shape[0],), n_cells, dtype=chosen.dtype,
            device=dev)])
    return torch.sort(chosen).values


def voxelize(points, points_mask, voxel_size, pc_range, grid_size,
             max_voxels: int, max_points_per_voxel: int):
    """Args:
        points: (N, C) float — first 3 channels are xyz
        points_mask: (N,) bool
        voxel_size: (vx, vy, vz); pc_range: (x0, y0, z0, x1, y1, z1);
        grid_size: (nx, ny, nz)
    Returns dict:
        voxels:           (max_voxels, max_points_per_voxel, C)
        voxel_coords:     (max_voxels, 3) int32 (z, y, x), -1 pad
        voxel_num_points: (max_voxels,) int32
        voxel_mask:       (max_voxels,) bool
        point_voxel_idx:  (N,) int32 — voxel slot of each point (-1 dropped)
    """
    nx, ny, nz = grid_size
    dev = points.device
    n = points.shape[0]
    vsize = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    trace.count('host_waits', 2)        # two pageable host-to-device copies

    coords = torch.floor((points[:, :3] - origin) / vsize).to(torch.int64)
    in_range = ((coords >= 0).all(dim=1) & (coords[:, 0] < nx)
                & (coords[:, 1] < ny) & (coords[:, 2] < nz) & points_mask)
    n_cells = nx * ny * nz
    vid = coords[:, 2] * (ny * nx) + coords[:, 1] * nx + coords[:, 0]
    vid = torch.where(in_range, vid, n_cells)

    # sort points by (vid, original index): the stable sort keeps input order
    sort_idx = torch.argsort(vid, stable=True)
    vid_sorted = vid[sort_idx]
    uniq = _select_voxels_first_occurrence(vid_sorted, sort_idx, n_cells,
                                           max_voxels)
    voxel_mask = uniq < n_cells

    # rank of each sorted point within its voxel run
    ar = torch.arange(n, device=dev)
    first_of_run = torch.ones(n, dtype=torch.bool, device=dev)
    first_of_run[1:] = vid_sorted[1:] != vid_sorted[:-1]
    run_start = torch.cummax(torch.where(first_of_run, ar, 0), 0).values
    rank = ar - run_start

    # voxel slot per sorted point (the selection is a subset of the ids, so
    # membership is checked, not just the insertion position)
    slot = torch.searchsorted(uniq, vid_sorted)
    member = uniq[slot.clamp(0, max_voxels - 1)] == vid_sorted
    valid_pt = ((vid_sorted < n_cells) & member
                & (rank < max_points_per_voxel) & (slot < max_voxels))
    # invalid points land in a dump row / column that is cut off below;
    # every valid (slot, rank) pair is unique
    slot_checked = torch.where(valid_pt, slot, max_voxels)
    rank_c = torch.where(valid_pt, rank, max_points_per_voxel)

    voxels = torch.zeros((max_voxels + 1, max_points_per_voxel + 1,
                          points.shape[1]), dtype=points.dtype, device=dev)
    voxels[slot_checked, rank_c] = points[sort_idx]
    voxels = voxels[:max_voxels, :max_points_per_voxel]
    voxel_num_points = torch.zeros(max_voxels + 1, dtype=torch.int32,
                                   device=dev).index_add_(
        0, slot_checked, valid_pt.to(torch.int32))[:max_voxels]

    z = uniq // (ny * nx)
    rem = uniq % (ny * nx)
    voxel_coords = torch.where(voxel_mask[:, None],
                               torch.stack([z, rem // nx, rem % nx], dim=1),
                               -1).to(torch.int32)
    point_voxel = torch.full((n,), -1, dtype=torch.int32, device=dev)
    point_voxel[sort_idx] = torch.where(valid_pt, slot, -1).to(torch.int32)
    return {
        'voxels': voxels,
        'voxel_coords': voxel_coords,
        'voxel_num_points': voxel_num_points,
        'voxel_mask': voxel_mask,
        'point_voxel_idx': point_voxel,
    }


def voxelize_dynamic(points, points_mask, voxel_size, pc_range, grid_size,
                     max_voxels: int):
    """Dynamic voxelization for the scatter-based VFEs: each point's voxel
    slot, with no cap on the points of a voxel and no (V, P, C) table.  The
    voxels are chosen as voxelize chooses them (at most max_voxels, by the
    first point that touched each, slots in linear-id order).

    Returns dict: voxel_coords (max_voxels, 3) int32 (z, y, x), -1 pad;
    voxel_mask (max_voxels,); point_voxel_idx (N,) int32, -1 for a point
    out of range, masked off or in a voxel past the budget.
    """
    nx, ny, nz = grid_size
    dev = points.device
    vsize = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    trace.count('host_waits', 2)        # two pageable host-to-device copies
    coords = torch.floor((points[:, :3] - origin) / vsize).to(torch.int64)
    in_range = ((coords >= 0).all(dim=1) & (coords[:, 0] < nx)
                & (coords[:, 1] < ny) & (coords[:, 2] < nz) & points_mask)
    n_cells = nx * ny * nz
    vid = coords[:, 2] * (ny * nx) + coords[:, 1] * nx + coords[:, 0]
    vid = torch.where(in_range, vid, n_cells)
    sort_idx = torch.argsort(vid, stable=True)
    uniq = _select_voxels_first_occurrence(vid[sort_idx], sort_idx, n_cells,
                                           max_voxels)
    voxel_mask = uniq < n_cells
    # the selection is a subset of the ids: membership is checked
    slot = torch.searchsorted(uniq, vid)
    hit = (slot < max_voxels) & in_range
    hit = hit & (uniq[slot.clamp(0, max_voxels - 1)] == vid)
    z = uniq // (ny * nx)
    rem = uniq % (ny * nx)
    voxel_coords = torch.where(voxel_mask[:, None],
                               torch.stack([z, rem // nx, rem % nx], dim=1),
                               -1).to(torch.int32)
    return {'voxel_coords': voxel_coords, 'voxel_mask': voxel_mask,
            'point_voxel_idx': torch.where(hit, slot, -1).to(torch.int32)}


def compute_grid_size(pc_range, voxel_size):
    grid = ((np.asarray(pc_range[3:6]) - np.asarray(pc_range[0:3]))
            / np.asarray(voxel_size))
    return tuple(int(g) for g in np.round(grid).astype(np.int64))  # nx,ny,nz
