"""RoI stage of GLENet-VR and Voxel R-CNN (torch counterpart of the
VoxelRCNN part of glenet_tpu/models/roi_heads.py): train-time RoI target
sampling, VoxelRCNNHead with or without its KL-label branches, and the
RCNN losses.

POOL_MODE picks how each of the G^3 grid points of a roi pools a feature
level:
  - 'corner' (default): the 8 ENCLOSING voxel corners; per corner
    h = mlp_in(feat) + mlp_pos(rel); pooled = max over corners; mlp_out.
    Corners come from a searchsorted lookup on the sorted ids of sparse
    levels and from direct index math on dense levels.
  - 'voxel_query': the reference's NeighborVoxelSAModuleMSG, the first
    NSAMPLE active voxels in scan order within POOL_RADIUS of the grid
    point (voxel_query_select), so reference checkpoints convert exactly.

Random draws (RoI sampling, dropout) come from an explicit
torch.Generator, and the sampler takes its draws as tensors, so a test can
feed it the JAX package's draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import iou3d
from ..utils import common, losses
from .layers import MaskedBatchNorm

_BIG = 1e9
# exclusive upper bound of the integer draws of the bg picks
RANDINT_HIGH = 1_000_000


# ---------------------------------------------------------------------------
# RoI target sampling (per sample, train only)
# ---------------------------------------------------------------------------

def draw_roi_sampling(n: int, r: int, generator=None, device=None):
    """The random draws of one sample's sample_rois_single: u_fg (n,)
    uniform in [0, 1), r_hard and r_easy (r,) integers in [0, 1e6)."""
    kw = dict(generator=generator, device=device)
    return (torch.rand((n,), **kw),
            torch.randint(0, RANDINT_HIGH, (r,), **kw),
            torch.randint(0, RANDINT_HIGH, (r,), **kw))


def sample_rois_single(rois, roi_scores, roi_labels, gt_boxes, gt_mask,
                       gt_unc, cfg, u_fg, r_hard, r_easy):
    """Subsample ROI_PER_IMAGE rois with the fg / hard-bg / easy-bg ratios
    of TARGET_CONFIG (ProposalTargetLayer semantics), static shapes.

    rois (N, 7), roi_scores (N,), roi_labels (N,), gt_boxes (M, 8) with the
    class id last, gt_mask (M,), gt_unc (M, 7); the draws u_fg (N,), r_hard
    (R,), r_easy (R,) from draw_roi_sampling.  Returns a dict of rois
    (R, 7), gt_of_rois_src (R, 8), roi_ious, roi_labels, roi_scores,
    gt_unc_of_rois (R, 7), reg_valid_mask (R,) int32, rcnn_cls_labels (R,).
    """
    r = int(cfg.ROI_PER_IMAGE)
    fg_per_image = int(round(cfg.FG_RATIO * r))
    reg_fg_thresh = float(cfg.REG_FG_THRESH)
    cls_fg_thresh = float(cfg.CLS_FG_THRESH)
    cls_bg_thresh = float(cfg.CLS_BG_THRESH)
    cls_bg_lo = float(cfg.CLS_BG_THRESH_LO)
    hard_bg_ratio = float(cfg.HARD_BG_RATIO)
    fg_thresh = min(reg_fg_thresh, cls_fg_thresh)
    dev = rois.device

    # same-class max IoU (SAMPLE_ROI_BY_EACH_CLASS)
    iou = iou3d.boxes_iou3d(rois[:, :7], gt_boxes[:, :7])         # (N, M)
    same_cls = roi_labels[:, None] == gt_boxes[None, :, 7].to(torch.int32)
    iou = torch.where(same_cls & gt_mask[None, :], iou, -1.0)
    max_iou_raw, gt_assign = iou.max(dim=1)
    max_iou = max_iou_raw.clamp_min(0.0)

    fg = max_iou >= fg_thresh
    easy_bg = max_iou < cls_bg_lo
    hard_bg = (max_iou < reg_fg_thresh) & (max_iou >= cls_bg_lo)

    # a random permutation of fg's True entries (stable: ties by index)
    fg_idx = torch.argsort(torch.where(fg, u_fg, _BIG),
                           stable=True)[:fg_per_image]
    n_fg_avail = fg.sum()
    n_hard = hard_bg.sum()
    n_easy = easy_bg.sum()
    n_fg = n_fg_avail.clamp_max(fg_per_image)
    n_bg = r - n_fg

    # bg: hard_num = min(n_bg * ratio, avail), easy fills the rest; when one
    # pool is empty the other fills everything (with replacement)
    hard_want = torch.where(n_easy > 0,
                            torch.minimum((n_bg * hard_bg_ratio).long(),
                                          n_hard),
                            n_bg)
    hard_want = torch.where(n_hard > 0, hard_want, 0)

    def pick_with_replacement(mask, draws):
        avail = mask.sum().clamp_min(1)
        idx_sorted = torch.argsort((~mask).to(torch.int32), stable=True)
        return idx_sorted[draws % avail]

    hard_idx = pick_with_replacement(hard_bg, r_hard)
    easy_idx = pick_with_replacement(easy_bg, r_easy)

    # [fg x n_fg, hard x hard_want, easy x the rest]
    slots = torch.arange(r, device=dev)
    take_fg = slots < n_fg
    take_hard = (slots >= n_fg) & (slots < n_fg + hard_want)
    sel = torch.where(take_fg, fg_idx[slots.clamp(0, fg_per_image - 1)],
                      torch.where(take_hard, hard_idx, easy_idx))
    # nothing available at all: the top-score rois, cyclically
    any_pool = (n_fg_avail + n_hard + n_easy) > 0
    sel = torch.where(any_pool, sel, slots % rois.shape[0])

    out_iou = max_iou[sel]
    gt_sel = gt_assign[sel]
    # CLS_SCORE_TYPE roi_iou: soft labels
    fg_m = out_iou > cls_fg_thresh
    interval = ~fg_m & ~(out_iou < cls_bg_thresh)
    cls_labels = torch.where(
        interval, (out_iou - cls_bg_thresh) / (cls_fg_thresh - cls_bg_thresh),
        fg_m.to(torch.float32))
    return {
        'rois': rois[sel], 'gt_of_rois_src': gt_boxes[gt_sel],
        'roi_ious': out_iou, 'roi_labels': roi_labels[sel],
        'roi_scores': roi_scores[sel], 'gt_unc_of_rois': gt_unc[gt_sel],
        'reg_valid_mask': (out_iou > reg_fg_thresh).to(torch.int32),
        'rcnn_cls_labels': cls_labels,
    }


def canonical_gt_of_rois(rois, gt_of_rois_src):
    """Gt boxes in the roi's canonical frame, heading flipped into
    [-pi/2, pi/2].  rois (R, 7), gt_of_rois_src (R, 8) -> (R, 7)."""
    roi_ry = rois[:, 6] % (2 * math.pi)
    gt = gt_of_rois_src[:, :7]
    shifted = gt[:, 0:3] - rois[:, 0:3]
    local = common.rotate_points_along_z(shifted[:, None, :], -roi_ry)[:, 0]
    heading = (gt[:, 6] - roi_ry) % (2 * math.pi)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, (heading + math.pi) % (2 * math.pi),
                          heading)
    heading = torch.where(heading > math.pi, heading - 2 * math.pi, heading)
    heading = heading.clamp(-math.pi / 2, math.pi / 2)
    return torch.cat([local, gt[:, 3:6], heading[:, None]], dim=1)


def dropout(x, p: float, generator=None):
    """Inverted dropout with the JAX package's semantics (keep with
    probability 1 - p, scale kept values by 1 / (1 - p)); draws from
    `generator`."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


# ---------------------------------------------------------------------------
# RoI grid pooling and the head
# ---------------------------------------------------------------------------

_CORNER_OFFS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def roi_grid_points(rois, grid_size: int):
    """(R, 7) rois -> (R, G^3, 3) global grid point coords; grid index
    order is row-major (d0, d1, d2)."""
    g = grid_size
    r = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(r, r, r, indexing='ij'),
                      dim=-1).reshape(-1, 3).to(torch.float32)
    sizes = rois[:, 3:6]
    local = (idx[None] + 0.5) / g * sizes[:, None] - sizes[:, None] / 2
    rotated = common.rotate_points_along_z(local, rois[:, 6])
    return rotated + rois[:, None, 0:3]


def _corner_cells(query_xyz, grid, stride, voxel_size, pc_range):
    """Integer (x, y, z) cells of the 8 corners around each query, their
    in-grid validity and metric centers relative to the query."""
    nx, ny, nz = grid
    dev = query_xyz.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    base = torch.floor((query_xyz - origin) / vs - 0.5).long()  # (..., 3)
    offs = torch.tensor(_CORNER_OFFS, device=dev)
    c = base[..., None, :] + offs                               # (..., 8, 3)
    cx, cy, cz = c.unbind(-1)
    valid = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
             & (cz >= 0) & (cz < nz))
    centers = (c.to(torch.float32) + 0.5) * vs + origin
    return cx, cy, cz, valid, centers - query_xyz[..., None, :]


def gather_corners_sparse(query_xyz, feats, ids, mask, grid, stride,
                          voxel_size, pc_range):
    """Corners from a sparse level, batched: query_xyz (B, Q, 3), feats
    (B, V, C), ids (B, V) sorted -> feats (B, Q, 8, C), rel (B, Q, 8, 3),
    valid (B, Q, 8)."""
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    b, v, c = feats.shape
    cx, cy, cz, valid, rel = _corner_cells(query_xyz, grid, stride,
                                           voxel_size, pc_range)
    tid = torch.where(valid, cz * (ny * nx) + cy * nx + cx, n_cells)
    flat_tid = tid.reshape(b, -1)
    pos = torch.searchsorted(ids.long(), flat_tid).clamp(0, v - 1)
    found = (ids.long().gather(1, pos) == flat_tid) & (flat_tid < n_cells)
    pos = torch.where(found, pos, v)
    padded = torch.cat([feats, feats.new_zeros((b, 1, c))], dim=1)
    cf = padded.gather(1, pos[..., None].expand(-1, -1, c))
    return (cf.reshape(*tid.shape, c), rel,
            found.reshape(tid.shape) & valid)


def gather_corners_dense(query_xyz, dense_feats, occ, grid, stride,
                         voxel_size, pc_range):
    """Corners from a dense level, batched: dense_feats (B, D, H, W, C) (may
    be a strided view), occ (B, D, H, W).  Out-of-grid corners read a
    clamped cell and are zeroed."""
    nx, ny, nz = grid
    b = dense_feats.shape[0]
    cx, cy, cz, valid, rel = _corner_cells(query_xyz, grid, stride,
                                           voxel_size, pc_range)
    bi = torch.arange(b, device=query_xyz.device).reshape(b, 1, 1)
    zi, yi, xi = cz.clamp(0, nz - 1), cy.clamp(0, ny - 1), cx.clamp(0, nx - 1)
    cf = torch.where(valid[..., None], dense_feats[bi, zi, yi, xi], 0.0)
    cv = occ[bi, zi, yi, xi] & valid
    return cf, rel, cv


class CornerAggregation(nn.Module):
    """Per-scale pooling: 8 enclosing voxel corners -> mlp_in + mlp_pos ->
    relu -> max -> mlp_out."""

    def __init__(self, cin: int, mlp_mid: int, mlp_out: int):
        super().__init__()
        self.mlp_in = nn.Linear(cin, mlp_mid, bias=False)
        self.bn_in = MaskedBatchNorm(mlp_mid)
        self.mlp_pos = nn.Linear(3, mlp_mid, bias=False)
        self.bn_pos = MaskedBatchNorm(mlp_mid)
        self.mlp_out = nn.Linear(mlp_mid, mlp_out, bias=False)
        self.bn_out = MaskedBatchNorm(mlp_out)

    def forward(self, corner_feats, rel_xyz, corner_valid, train=False):
        """corner_feats (Q, 8, C); rel_xyz (Q, 8, 3); corner_valid (Q, 8)."""
        ra = not train
        h = self.bn_in(self.mlp_in(corner_feats), mask=corner_valid,
                       use_running_average=ra)
        p = self.bn_pos(self.mlp_pos(rel_xyz), mask=corner_valid,
                        use_running_average=ra)
        h = torch.where(corner_valid[..., None], F.relu(h + p), 0.0)
        pooled = h.amax(dim=1)
        return F.relu(self.bn_out(self.mlp_out(pooled),
                                  use_running_average=ra))


def ball_taps(query_range, radius, voxel_size_lvl):
    """Static scan-ordered (dz, dy, dx) taps that can contain a neighbour
    within `radius` of a query point anywhere in its cell: the reference
    voxel_query kernel scans dz (outer) / dy / dx (inner) over
    +-query_range and accepts neighbours whose CENTRE lies within the
    metric radius; a tap at cell offset d can hold one only if
    max(0, |d| - 0.5) * vs is within the ball per axis.  Returns (T, 3)
    int32 in the kernel's scan order (a numpy array: the pooling caches
    its device copy)."""
    zr, yr, xr = (int(v) for v in query_range)
    vx, vy, vz = (float(v) for v in voxel_size_lvl)
    taps = []
    for dz in range(-zr, zr + 1):
        mz = max(0.0, abs(dz) - 0.5) * vz
        for dy in range(-yr, yr + 1):
            my = max(0.0, abs(dy) - 0.5) * vy
            for dx in range(-xr, xr + 1):
                mx = max(0.0, abs(dx) - 0.5) * vx
                if mx * mx + my * my + mz * mz <= radius * radius + 1e-6:
                    taps.append((dz, dy, dx))
    return np.asarray(taps, np.int32)


def voxel_query_select(query_xyz, v2p, taps, grid, vs, origin, radius,
                       nsample: int):
    """The first `nsample` active neighbours in scan order within the
    metric ball of each query, batched (reference voxel_query semantics,
    unfilled slots replicate the first hit).

    query_xyz (B, Q, 3) metric grid points; v2p (B, n_cells) int32, the
    active slot of each cell or -1; taps (T, 3) int32 from ball_taps on the
    queries' device; grid (nx, ny, nz); vs (3,) f32 metric voxel size of
    the level; origin (3,) f32, pc_range[:3].  Returns slots (B, Q,
    nsample) int64 (0 where the ball is empty), centres (B, Q, nsample, 3)
    of the selected voxels and empty (B, Q) bool.
    """
    nx, ny, nz = grid
    b, q = query_xyz.shape[:2]
    t = taps.shape[0]
    cells = torch.floor((query_xyz - origin) / vs).to(torch.int32)
    cells = cells.reshape(b, q, 1, 3)
    tx = cells[..., 0] + taps[:, 2]                           # (B, Q, T)
    ty = cells[..., 1] + taps[:, 1]
    tz = cells[..., 2] + taps[:, 0]
    in_rng = ((tz >= 0) & (tz < nz) & (ty >= 0) & (ty < ny)
              & (tx >= 0) & (tx < nx))
    # one int32 row gather over the batch: sample i's table starts at
    # i * v2p.stride(0) of v2p's storage (v2p may be a sliced view)
    row0 = torch.arange(b, dtype=torch.int32, device=v2p.device) \
        * v2p.stride(0)
    tid = torch.where(in_rng, tz * (ny * nx) + ty * nx + tx, 0) \
        + row0.reshape(b, 1, 1)
    flat = v2p.as_strided(((b - 1) * v2p.stride(0) + v2p.shape[1],), (1,))
    slot = flat.index_select(0, tid.reshape(-1)).reshape(tid.shape)
    del tid
    d2 = None
    for c, axis in ((tx, 0), (ty, 1), (tz, 2)):
        d = ((c.to(torch.float32) + 0.5) * vs[axis] + origin[axis]
             - query_xyz[..., axis:axis + 1])
        d2 = d * d if d2 is None else d2 + d * d
    valid = in_rng & (slot >= 0) & (d2 <= radius * radius)
    del d2, in_rng, tx, ty, tz
    # the valid taps in scan order first, then the others in scan order:
    # distinct keys, so the order is that of the reference's stable top_k
    tap_idx = torch.arange(t, dtype=torch.int32, device=query_xyz.device)
    keys = torch.where(valid, tap_idx, t + tap_idx)
    k = min(nsample, t)
    top, sel = torch.topk(keys, k, dim=-1, largest=False, sorted=True)
    ok = top < t
    s16 = torch.gather(slot, 2, sel).long()
    if k < nsample:       # coarse levels can have fewer taps than slots
        pad = nsample - k
        ok = F.pad(ok, (0, pad), value=False)
        sel = F.pad(sel, (0, pad))
        s16 = F.pad(s16, (0, pad))
    cen = ((cells + taps[sel][..., [2, 1, 0]]).to(torch.float32) + 0.5) \
        * vs + origin                                         # (B,Q,ns,3)
    empty = ~ok[..., 0]
    s16 = torch.where(ok, s16, s16[..., :1])
    cen = torch.where(ok[..., None], cen, cen[..., :1, :])
    s16 = torch.where(empty[..., None], 0, s16)
    return s16, cen, empty


class VoxelQueryPool(nn.Module):
    """Per-level RoI pooling of the reference (NeighborVoxelSAModuleMSG):
    mlp_in (linear + BN over the active voxels) -> the first NSAMPLE
    neighbours of voxel_query_select -> mlp_pos on (neighbour centre - grid
    point) -> relu(sum) -> max or avg over the neighbours -> mlp_out.  The
    BNs over the grouped tensors are UNMASKED (the reference normalises
    over every grouped slot, empty balls included); every BN has torch's
    default eps 1e-5."""

    def __init__(self, cin: int, mlp_mid: int, mlp_out: int, query_range,
                 radius: float, nsample: int, pool_method: str):
        super().__init__()
        self.mlp_in = nn.Linear(cin, mlp_mid, bias=False)
        self.bn_in = MaskedBatchNorm(mlp_mid, eps=1e-5)
        self.mlp_pos = nn.Linear(3, mlp_mid, bias=False)
        self.bn_pos = MaskedBatchNorm(mlp_mid, eps=1e-5)
        self.mlp_out = nn.Linear(mlp_mid, mlp_out, bias=False)
        self.bn_out = MaskedBatchNorm(mlp_out, eps=1e-5)
        self.query_range = tuple(int(v) for v in query_range)
        self.radius, self.nsample = float(radius), int(nsample)
        self.pool_method = pool_method
        # (level voxel size, origin, device) -> the taps, voxel size and
        # origin on the device, built once (no host copy per call)
        self._consts = {}

    def consts(self, vs, origin, device):
        key = (vs, origin, str(device))
        if key not in self._consts:
            self._consts[key] = tuple(
                torch.as_tensor(a, device=device) for a in (
                    ball_taps(self.query_range, self.radius, vs),
                    np.asarray(vs, np.float32),
                    np.asarray(origin, np.float32)))
        return self._consts[key]

    def forward(self, feats, active_mask, v2p, grid_pts, grid, vs, origin,
                train: bool = False):
        """feats (B, N, C) active-voxel features, active_mask (B, N), v2p
        (B, n_cells) int32 slot or -1, grid_pts (B, Q, 3); the level's grid,
        metric voxel size vs and origin (tuples of floats).  Returns
        (B, Q, mlp_out)."""
        ra = not train
        b, n, _ = feats.shape
        h = self.bn_in(self.mlp_in(feats), mask=active_mask,
                       use_running_average=ra)
        dev = grid_pts.device
        taps, vs_t, origin_t = self.consts(vs, origin, dev)
        s16, cen, empty = voxel_query_select(
            grid_pts, v2p, taps, grid, vs_t, origin_t, self.radius,
            self.nsample)
        off = (torch.arange(b, device=dev) * n).reshape(b, 1, 1)
        # index_select: its backward is an index_add_, where advanced
        # indexing's sorts the indices first (~47 ms per level and train
        # step at full width on an H100)
        grouped = h.reshape(b * n, -1).index_select(
            0, (s16 + off).reshape(-1)).reshape(*s16.shape, -1)  # (B,Q,ns,mid)
        grouped = torch.where(empty[..., None, None], 0.0, grouped)
        rel = torch.where(empty[..., None, None], 0.0,
                          cen - grid_pts[:, :, None, :])
        p = self.bn_pos(self.mlp_pos(rel), use_running_average=ra)
        g = F.relu(grouped + p)
        pooled = g.mean(dim=2) if self.pool_method == 'avg_pool' \
            else g.amax(dim=2)
        return F.relu(self.bn_out(self.mlp_out(pooled),
                                  use_running_average=ra))


def level_slot_table(level):
    """(features (B, N, C), active mask (B, N), v2p (B, n_cells) int32) of
    one backbone level for voxel_query pooling: a sparse level scatters
    each active slot's index to its cell; a dense level's slots are its
    cells, z-major (cell z * ny * nx + y * nx + x), active where occupied."""
    nx, ny, nz = level['grid']
    n_cells = nx * ny * nz
    if level['kind'] == 'sparse':
        feats, mask, ids = level['features'], level['mask'], level['ids']
        b, v = ids.shape
        v2p = torch.full((b, n_cells + 1), -1, dtype=torch.int32,
                         device=ids.device)
        v2p.scatter_(1, torch.where(mask, ids, n_cells).long(),
                     torch.arange(v, dtype=torch.int32,
                                  device=ids.device).expand(b, v))
        return feats, mask, v2p[:, :n_cells]
    dense = level['features']                   # (B, D, H, W, C), a view
    b = dense.shape[0]
    mask = level['occ'].reshape(b, n_cells)
    cells = torch.arange(n_cells, dtype=torch.int32, device=dense.device)
    return (dense.reshape(b, n_cells, dense.shape[-1]), mask,
            torch.where(mask, cells, -1))


POOL_MODES = ('corner', 'voxel_query')


class VoxelRCNNHead(nn.Module):
    """RoI refinement head: VoxelRCNNKLLabelIoUHead (kl_label, with the
    reg_std and variance -> confidence branches) or the plain
    VoxelRCNNHead (rcnn_cls is the raw logit), with either POOL_MODE.  In
    train mode every BatchNorm uses batch moments and DP_RATIO dropout
    follows the first FC of each stack.

    level_channels: channels of each FEATURES_SOURCE level.
    """

    def __init__(self, model_cfg, voxel_size, pc_range, level_channels: dict,
                 code_size: int = 7, kl_label: bool = True):
        super().__init__()
        pool_cfg = model_cfg.ROI_GRID_POOL
        self.pool_mode = str(pool_cfg.get('POOL_MODE', 'corner'))
        if self.pool_mode not in POOL_MODES:
            raise NotImplementedError(
                f'POOL_MODE {self.pool_mode} is not ported yet')
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        self.sources = list(pool_cfg.FEATURES_SOURCE)
        self.grid = int(pool_cfg.GRID_SIZE)
        self.dp_ratio = float(model_cfg.get('DP_RATIO', 0.0))
        self.kl_label = kl_label
        c_pooled = 0
        for src in self.sources:
            lay = pool_cfg.POOL_LAYERS[src]
            mid, out = lay['MLPS'][0]
            if self.pool_mode == 'voxel_query':
                pool = VoxelQueryPool(
                    level_channels[src], mid, out, lay['QUERY_RANGES'][0],
                    float(lay['POOL_RADIUS'][0]), int(lay['NSAMPLE'][0]),
                    str(lay.get('POOL_METHOD', 'max_pool')))
            else:
                pool = CornerAggregation(level_channels[src], mid, out)
            setattr(self, f'pool_{src}', pool)
            c_pooled += out
        c = c_pooled * self.grid ** 3
        self.fc_names = {}
        for stack, key in (('shared', 'SHARED_FC'), ('cls_fc', 'CLS_FC'),
                           ('reg_fc', 'REG_FC')):
            c_in = c if stack == 'shared' else int(model_cfg.SHARED_FC[-1])
            names = []
            for i, s in enumerate(model_cfg[key]):
                # torch-default eps: the reference head FCs use BatchNorm1d
                bn = f'{stack}_bn{i}'
                setattr(self, f'{stack}_{i}', nn.Linear(c_in, s, bias=False))
                setattr(self, bn, MaskedBatchNorm(s, eps=1e-5))
                names.append((f'{stack}_{i}', bn))
                c_in = s
            self.fc_names[stack] = names
        c_cls = int(model_cfg.CLS_FC[-1])
        c_reg = int(model_cfg.REG_FC[-1])
        self.cls_pred = nn.Linear(c_cls, 1)
        self.reg_pred = nn.Linear(c_reg, code_size)
        nn.init.normal_(self.reg_pred.weight, std=0.001)
        if not kl_label:
            return
        # variance -> confidence: BN - ReLU - FC(64) - BN - ReLU - FC(1)
        self.reg_std = nn.Linear(c_reg, code_size)
        self.std_bn0 = MaskedBatchNorm(code_size, eps=1e-5)
        self.std_fc1 = nn.Linear(code_size, 64)
        self.std_bn1 = MaskedBatchNorm(64, eps=1e-5)
        self.std_fc2 = nn.Linear(64, 1)
        for lin in (self.reg_std, self.std_fc1, self.std_fc2):
            nn.init.normal_(lin.weight, std=0.0001)
            nn.init.zeros_(lin.bias)

    def _fc_stack(self, x, stack, train, generator):
        for i, (lin, bn) in enumerate(self.fc_names[stack]):
            x = F.relu(getattr(self, bn)(getattr(self, lin)(x),
                                         use_running_average=not train))
            if i == 0 and train and self.dp_ratio > 0:
                x = dropout(x, self.dp_ratio, generator)
        return x

    def pool_level(self, src, grid_pts, level, train: bool = False):
        """Pool one FEATURES_SOURCE level at grid_pts (B, Q, 3) -> (B * Q,
        C_out)."""
        pool = getattr(self, f'pool_{src}')
        b, q = grid_pts.shape[:2]
        if self.pool_mode == 'voxel_query':
            feats, mask, v2p = level_slot_table(level)
            vs = tuple(float(v) * level['stride'] for v in self.voxel_size)
            out = pool(feats, mask, v2p, grid_pts, level['grid'], vs,
                       self.pc_range[:3], train)
            return out.reshape(b * q, -1)
        if level['kind'] == 'sparse':
            cf, rel, cv = gather_corners_sparse(
                grid_pts, level['features'], level['ids'], level['mask'],
                level['grid'], level['stride'], self.voxel_size,
                self.pc_range)
        else:
            cf, rel, cv = gather_corners_dense(
                grid_pts, level['features'], level['occ'], level['grid'],
                level['stride'], self.voxel_size, self.pc_range)
        return pool(cf.reshape(b * q, 8, -1), rel.reshape(b * q, 8, 3),
                    cv.reshape(b * q, 8), train)

    def forward(self, rois, multi_scale, train: bool = False,
                generator=None):
        """rois (B, R, 7) -> rcnn_cls (B*R, 1), rcnn_reg (B*R, C) and, with
        kl_label, rcnn_reg_std (B*R, C).  `generator` feeds the dropout
        draws."""
        g = self.grid
        b, r = rois.shape[:2]
        grid_pts = roi_grid_points(rois.reshape(b * r, -1), g)
        grid_pts = grid_pts.reshape(b, r * g ** 3, 3)
        pooled = [self.pool_level(src, grid_pts, multi_scale[src], train)
                  for src in self.sources]
        feats = torch.cat(pooled, dim=-1).reshape(b * r, -1)

        shared = self._fc_stack(feats, 'shared', train, generator)
        ori_cls = self.cls_pred(self._fc_stack(shared, 'cls_fc', train,
                                               generator))
        reg_feat = self._fc_stack(shared, 'reg_fc', train, generator)
        if not self.kl_label:
            return {'rcnn_cls': ori_cls, 'rcnn_reg': self.reg_pred(reg_feat)}
        reg_std = self.reg_std(reg_feat)
        ra = not train
        h = F.relu(self.std_bn0(reg_std, use_running_average=ra))
        h = F.relu(self.std_bn1(self.std_fc1(h), use_running_average=ra))
        p = torch.sigmoid(ori_cls) * torch.sigmoid(self.std_fc2(h))
        return {'rcnn_cls': torch.log((p + 1e-6) / (1 - p + 1e-6)),
                'rcnn_reg': self.reg_pred(reg_feat), 'rcnn_reg_std': reg_std}


def decode_rcnn_boxes(rois, rcnn_reg, box_coder):
    """rois (B, R, 7), rcnn_reg (B*R, C) -> (B, R, 7) global boxes."""
    b, r = rois.shape[:2]
    flat_rois = rois.reshape(b * r, -1)
    local_rois = torch.cat([torch.zeros_like(flat_rois[:, :3]),
                            flat_rois[:, 3:]], dim=1)
    dec = box_coder.decode(rcnn_reg, local_rois[:, :box_coder.code_size])
    rotated = common.rotate_points_along_z(dec[:, None, :],
                                           flat_rois[:, 6])[:, 0]
    rotated = torch.cat([rotated[:, :3] + flat_rois[:, :3], rotated[:, 3:]],
                        dim=1)
    return rotated.reshape(b, r, -1)


def rcnn_cls_loss(rcnn_cls, rcnn_cls_labels):
    """BCE on the IoU-derived soft labels, mean over labels >= 0."""
    logits = rcnn_cls.reshape(-1)
    labels = rcnn_cls_labels.reshape(-1)
    loss = losses.sigmoid_bce_with_logits(logits, labels)
    valid = (labels >= 0).to(torch.float32)
    return (loss * valid).sum() / valid.sum().clamp_min(1.0)


def rcnn_reg_loss(rcnn_reg, rcnn_reg_std, rois, gt_of_rois_ct,
                  gt_of_rois_src, gt_unc_of_rois, reg_valid_mask, box_coder,
                  loss_weights, corner_weight=1.0, code_weights=None):
    """Regression loss over fg rois plus the corner loss, both normalised
    by the fg count.  With rcnn_reg_std (the KL-label head), per fg roi and
    code dim, s the predicted log variance (clamped >= -50) and t =
    log(label variance + 1e-10):
        exp(-s) * smoothL1 + exp(t - s) - 0.5 * (t - s)
    reported as the terms src, square and log; with rcnn_reg_std None (the
    plain head), the weighted smooth-L1 alone."""
    b, r = rois.shape[:2]
    n = b * r
    flat_rois = rois.reshape(n, -1)[:, :box_coder.code_size]
    zeros3 = torch.zeros_like(flat_rois[:, :3])
    rois_anchor = torch.cat([zeros3, flat_rois[:, 3:6],
                             torch.zeros_like(flat_rois[:, 6:7]),
                             flat_rois[:, 7:]], dim=1)
    reg_targets = box_coder.encode(gt_of_rois_ct.reshape(n, -1)[:, :7],
                                   rois_anchor)
    fg = reg_valid_mask.reshape(n) > 0
    fg_sum = fg.sum().clamp_min(1).to(torch.float32)
    rcnn_reg = rcnn_reg.reshape(n, -1)

    l1 = losses.weighted_smooth_l1(rcnn_reg[None], reg_targets[None],
                                   code_weights=code_weights)[0]
    w = loss_weights['rcnn_reg_weight']
    fgf = fg[:, None].to(torch.float32)
    if rcnn_reg_std is None:
        reg_loss = (l1 * fgf).sum() / fg_sum * w
        metrics = {}
    else:
        s = rcnn_reg_std.reshape(n, -1).clamp_min(-50.0)
        t = torch.log(gt_unc_of_rois.reshape(n, -1) + 1e-10)
        src = (torch.exp(-s) * l1 * fgf).sum() / fg_sum * w
        square = (torch.exp(t - s) * fgf).sum() / fg_sum * w
        log_t = (-0.5 * (t - s) * fgf).sum() / fg_sum * w
        reg_loss = src + square + log_t
        metrics = {'rcnn_loss_reg_src': src, 'rcnn_loss_reg_square': square,
                   'rcnn_loss_reg_log': log_t}

    # corner loss of the decoded global boxes on fg rois
    local_anchor = torch.cat([zeros3, flat_rois[:, 3:]], dim=1)
    dec = box_coder.decode(rcnn_reg, local_anchor)
    dec = common.rotate_points_along_z(dec[:, None, :], flat_rois[:, 6])[:, 0]
    dec = torch.cat([dec[:, 0:3] + flat_rois[:, 0:3], dec[:, 3:]], dim=1)
    corner = losses.corner_loss_lidar(
        dec[:, :7], gt_of_rois_src.reshape(n, -1)[:, :7])
    corner = (corner * fg).sum() / fg_sum * corner_weight
    metrics['rcnn_loss_corner'] = corner
    return reg_loss + corner, metrics
