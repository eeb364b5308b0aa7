"""Host-side augmentation geometry (numpy; the port's own copy of
glenet_tpu/datasets/augmentor_utils.py):

  - BEV rectangle corners and their separating-axis overlap test (the host
    library's plain collision test);
  - noise_per_object: per-object pose jitter, a candidate rejected when
    its BEV rectangle collides with another box;
  - world and local translations, local rotation and scaling;
  - global and local frustum dropouts;
  - SE-SSD's pyramid dropout / sparsify / swap (convex-hull membership by
    scipy's Delaunay).

Every function draws from the `rng` (np.random.RandomState) it is given,
in the JAX package's order, and returns copies.
"""
from __future__ import annotations

import numpy as np

MARGIN = 1e-1
_AXIS = {'x': 0, 'y': 1, 'z': 2}


def _rotz(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float64)


def get_points_in_box(points, gt_box):
    """(M, 3+C), (7,) -> mask (M,): xy in the box's rotated frame with a
    0.1 m margin, z axis-aligned."""
    shift = points[:, :3] - gt_box[:3]
    c, s = np.cos(-gt_box[6]), np.sin(-gt_box[6])
    local_x = shift[:, 0] * c - shift[:, 1] * s
    local_y = shift[:, 0] * s + shift[:, 1] * c
    return ((np.abs(shift[:, 2]) <= gt_box[5] / 2.0)
            & (np.abs(local_x) <= gt_box[3] / 2.0 + MARGIN)
            & (np.abs(local_y) <= gt_box[4] / 2.0 + MARGIN))


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


def noise_per_object(gt_boxes, points, valid_mask=None,
                     rotation_perturb=(-np.pi / 4, np.pi / 4),
                     center_noise_std=(1.0, 1.0, 0.5), num_try=100,
                     rng=None):
    """Independent per-object pose jitter with collision rejection
    (reference noise_per_object :155-231 + noise_per_box :256-288).

    Per valid box, the first of `num_try` (gaussian loc, uniform rot) noises
    whose jittered BEV rectangle collides with no other box (current state)
    is applied to the box and to the points inside it (rotation about the
    box center, then translation).  Points are assigned to the first box
    containing them.

    Returns (gt_boxes, points) copies.
    """
    rng = rng or np.random
    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = (-rotation_perturb, rotation_perturb)
    n = gt_boxes.shape[0]
    if valid_mask is None:
        valid_mask = np.ones(n, bool)
    valid_mask = np.asarray(valid_mask, bool)
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    if n == 0:
        return gt_boxes, points

    loc_noises = rng.normal(
        scale=np.asarray(center_noise_std, np.float64), size=(n, num_try, 3))
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1],
                             size=(n, num_try))

    # point-to-box assignment on the ORIGINAL (slightly enlarged) boxes,
    # first-match-wins (reference uses convex-hull surfaces of boxes+0.03)
    grown = gt_boxes.copy()
    grown[:, 3:6] += 0.03
    inmask = np.stack([get_points_in_box(points, b) for b in grown], axis=1) \
        if n else np.zeros((len(points), 0), bool)
    first = inmask.argmax(axis=1)
    has_box = inmask.any(axis=1)

    corners = _bev_corners(gt_boxes[:, [0, 1, 3, 4, 6]])     # current state
    loc_sel = np.zeros((n, 3))
    rot_sel = np.zeros((n,))
    for i in range(n):
        if not valid_mask[i]:
            continue
        # all num_try candidates for box i, vectorized
        base = corners[i] - gt_boxes[i, :2]                  # (4, 2)
        cs, sn = np.cos(rot_noises[i]), np.sin(rot_noises[i])
        rot = np.stack([np.stack([cs, sn], -1),
                        np.stack([-sn, cs], -1)], -2)        # (T, 2, 2)
        cand = base[None] @ rot + (gt_boxes[i, :2]
                                   + loc_noises[i, :, :2])[:, None]
        others = np.delete(corners, i, axis=0)
        if others.shape[0]:
            coll = _sat_overlap(cand, others).any(axis=1)    # (T,)
        else:
            coll = np.zeros(num_try, bool)
        ok = np.nonzero(~coll)[0]
        if ok.size:
            t = ok[0]
            loc_sel[i] = loc_noises[i, t]
            rot_sel[i] = rot_noises[i, t]
            corners[i] = cand[t]

    # apply to points (first containing valid box wins)
    move = has_box & valid_mask[first]
    idx = first[move]
    centers = gt_boxes[idx, :3]
    local = points[move, :3] - centers
    cs, sn = np.cos(rot_sel[idx]), np.sin(rot_sel[idx])
    rx = local[:, 0] * cs - local[:, 1] * sn
    ry = local[:, 0] * sn + local[:, 1] * cs
    points[move, 0] = rx + centers[:, 0] + loc_sel[idx, 0]
    points[move, 1] = ry + centers[:, 1] + loc_sel[idx, 1]
    points[move, 2] = local[:, 2] + centers[:, 2] + loc_sel[idx, 2]

    gt_boxes[valid_mask, :3] += loc_sel[valid_mask]
    gt_boxes[valid_mask, 6] += rot_sel[valid_mask]
    return gt_boxes, points


# ---------------------------------------------------------------------------
# translations / local rotation / local scaling
# ---------------------------------------------------------------------------

def random_translation_along_axis(gt_boxes, points, offset_std, axis, rng):
    offset = rng.normal(0, offset_std)
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, _AXIS[axis]] += offset
    gt_boxes[:, _AXIS[axis]] += offset
    return gt_boxes, points


def random_local_translation_along_axis(gt_boxes, points, offset_range,
                                        axis, rng):
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    for i, box in enumerate(gt_boxes):
        offset = rng.uniform(offset_range[0], offset_range[1])
        mask = get_points_in_box(points, box)
        points[mask, _AXIS[axis]] += offset
        gt_boxes[i, _AXIS[axis]] += offset
    return gt_boxes, points


def local_rotation(gt_boxes, points, rot_range, rng):
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    for i, box in enumerate(gt_boxes):
        angle = rng.uniform(rot_range[0], rot_range[1])
        mask = get_points_in_box(points, box)
        center = box[:3].copy()
        points[mask, :3] = (points[mask, :3] - center) @ _rotz(angle) + center
        gt_boxes[i, 6] += angle
    return gt_boxes, points


def local_scaling(gt_boxes, points, scale_range, rng):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    for i, box in enumerate(gt_boxes):
        scale = rng.uniform(scale_range[0], scale_range[1])
        mask = get_points_in_box(points, box)
        center = box[:3].copy()
        points[mask, :3] = (points[mask, :3] - center) * scale + center
        gt_boxes[i, 3:6] *= scale
    return gt_boxes, points


# ---------------------------------------------------------------------------
# frustum dropouts
# ---------------------------------------------------------------------------

def global_frustum_dropout(gt_boxes, points, intensity_range, direction, rng):
    """Cut the scene's top / bottom (on z) or left / right (on y) by a drawn
    share of its extent: the points and the boxes whose centres lie beyond
    the cut go.  Returns (gt_boxes, points, the kept boxes' mask)."""
    intensity = rng.uniform(intensity_range[0], intensity_range[1])
    col = 2 if direction in ('top', 'bottom') else 1
    lo, hi = points[:, col].min(), points[:, col].max()
    if direction in ('top', 'left'):
        thr = hi - intensity * (hi - lo)
        keep_p = points[:, col] < thr
        keep_b = gt_boxes[:, col] < thr
    else:
        thr = lo + intensity * (hi - lo)
        keep_p = points[:, col] > thr
        keep_b = gt_boxes[:, col] > thr
    return gt_boxes[keep_b], points[keep_p], keep_b


def local_frustum_dropout(gt_boxes, points, intensity_range, direction, rng):
    """Per box, drop its points within a drawn share of its height (top /
    bottom) or width (left / right) from that side."""
    points = points.copy()
    keep = np.ones(len(points), bool)
    for box in gt_boxes:
        intensity = rng.uniform(intensity_range[0], intensity_range[1])
        mask = get_points_in_box(points, box)
        z, dz, y, dy = box[2], box[5], box[1], box[4]
        if direction == 'top':
            drop = mask & (points[:, 2] >= (z + dz / 2) - intensity * dz)
        elif direction == 'bottom':
            drop = mask & (points[:, 2] <= (z - dz / 2) + intensity * dz)
        elif direction == 'left':
            drop = mask & (points[:, 1] >= (y + dy / 2) - intensity * dy)
        else:
            drop = mask & (points[:, 1] <= (y - dy / 2) + intensity * dy)
        keep &= ~drop
    return gt_boxes, points[keep]


# ---------------------------------------------------------------------------
# SE-SSD's pyramid augmentations
# ---------------------------------------------------------------------------

# the 4 corners (of _corners3d's 8) of each of a box's 6 faces
_PYRAMID_ORDERS = np.array([
    [0, 1, 5, 4], [4, 5, 6, 7], [7, 6, 2, 3],
    [3, 2, 1, 0], [1, 2, 6, 5], [0, 4, 7, 3]])


def _corners3d(boxes):
    """(N, 7) -> (N, 8, 3) corners in pcdet's order."""
    template = np.array([[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
                        np.float64) / 2
    corners = boxes[:, None, 3:6] * template[None]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    rx = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    ry = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    out = np.stack([rx, ry, corners[..., 2]], -1)
    return out + boxes[:, None, 0:3]


def get_pyramids(boxes):
    """(N, 7) -> (N, 6, 15): per face the apex (the box centre) and the
    face's 4 corners."""
    corners = _corners3d(boxes).reshape(-1, 24)
    pyr = []
    for order in _PYRAMID_ORDERS:
        pyr.append(np.concatenate(
            [boxes[:, 0:3]] + [corners[:, 3 * o: 3 * o + 3] for o in order],
            axis=1)[:, None, :])
    return np.concatenate(pyr, axis=1)


def _in_hull(points, hull_pts):
    """Membership of `points` in the convex hull of `hull_pts` (Delaunay);
    a degenerate hull holds nothing."""
    from scipy.spatial import Delaunay
    try:
        hull = Delaunay(hull_pts)
    except Exception:  # degenerate hull (QhullError)
        return np.zeros(len(points), bool)
    return hull.find_simplex(points) >= 0


def points_in_pyramids_mask(points, pyramids):
    pyramids = pyramids.reshape(-1, 5, 3)
    flags = np.zeros((points.shape[0], pyramids.shape[0]), bool)
    for i, pyr in enumerate(pyramids):
        flags[:, i] = _in_hull(points[:, 0:3], pyr)
    return flags


def local_pyramid_dropout(gt_boxes, points, dropout_prob, rng, pyramids=None):
    """Per box with probability dropout_prob, drop the points of one drawn
    face's pyramid; the dropped boxes' pyramids leave the pool."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes).reshape(-1, 6, 5, 3)
    drop_idx = rng.randint(0, 6, pyramids.shape[0])
    drop_box = rng.uniform(0, 1, pyramids.shape[0]) <= dropout_prob
    if drop_box.sum():
        sel = np.zeros((pyramids.shape[0], 6), bool)
        sel[np.arange(len(drop_idx)), drop_idx] = True
        sel &= drop_box[:, None]
        masks = points_in_pyramids_mask(points, pyramids[sel])
        points = points[~masks.any(-1)]
    pyramids = pyramids[~drop_box]
    return gt_boxes, points, pyramids


def local_pyramid_sparsify(gt_boxes, points, prob, max_num_pts, rng,
                           pyramids=None):
    """Per remaining box with probability `prob`, thin one drawn face's
    pyramid to max_num_pts points when it holds more; the drawn boxes'
    pyramids leave the pool."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes).reshape(-1, 6, 5, 3)
    if pyramids.shape[0] > 0:
        sp_idx = rng.randint(0, 6, pyramids.shape[0])
        sp_box = rng.uniform(0, 1, pyramids.shape[0]) <= prob
        sel = np.zeros((pyramids.shape[0], 6), bool)
        sel[np.arange(len(sp_idx)), sp_idx] = True
        sel &= sp_box[:, None]
        sampled = pyramids[sel]
        masks = points_in_pyramids_mask(points, sampled)
        valid = masks.sum(0) > max_num_pts
        if sampled[valid].shape[0] > 0:
            masks = masks[:, valid]
            remain = points[~masks.any(-1)]
            kept = []
            for i in range(masks.shape[1]):
                sample = points[masks[:, i]]
                sel_idx = rng.choice(sample.shape[0], size=max_num_pts,
                                     replace=False)
                kept.append(sample[sel_idx])
            points = np.concatenate([remain] + kept, axis=0)
        pyramids = pyramids[~sp_box]
    return gt_boxes, points, pyramids


def local_pyramid_swap(gt_boxes, points, prob, max_num_pts, rng,
                       pyramids=None):
    """Per remaining box with probability `prob`, swap the points of one
    drawn face's pyramid (of more than max_num_pts points) with the same
    face of another such box, carried over in each pyramid's own
    (alpha, beta, gamma) coordinates, intensities rescaled to the
    receiver's range."""
    def ratios(pts, pyr):
        sc = (pyr[3:6] + pyr[6:9] + pyr[9:12] + pyr[12:]) / 4.0
        v0, v1, v2 = pyr[6:9] - pyr[3:6], pyr[12:] - pyr[3:6], pyr[0:3] - sc
        a = ((pts[:, :3] - pyr[3:6]) * v0).sum(-1) / (v0 ** 2).sum()
        b = ((pts[:, :3] - pyr[3:6]) * v1).sum(-1) / (v1 ** 2).sum()
        g = ((pts[:, :3] - sc) * v2).sum(-1) / (v2 ** 2).sum()
        return a, b, g

    def recover(r, pyr):
        a, b, g = r
        sc = (pyr[3:6] + pyr[6:9] + pyr[9:12] + pyr[12:]) / 4.0
        v0, v1, v2 = pyr[6:9] - pyr[3:6], pyr[12:] - pyr[3:6], pyr[0:3] - sc
        return (a[:, None] * v0 + b[:, None] * v1) + pyr[3:6] \
            + g[:, None] * v2

    def iratio(p):
        lo, hi = p[:, -1:].min(), p[:, -1:].max()
        return (p[:, -1:] - lo) / np.clip(hi - lo, 1e-6, 1), lo, hi

    if pyramids is None:
        pyramids = get_pyramids(gt_boxes).reshape(-1, 6, 5, 3)
    swap_box = rng.uniform(0, 1, pyramids.shape[0]) <= prob
    if swap_box.sum() == 0:
        return gt_boxes, points
    masks_all = points_in_pyramids_mask(points, pyramids)
    nums = masks_all.sum(0).reshape(pyramids.shape[0], 6)
    eligible = nums > max_num_pts
    selected = eligible & swap_box[:, None]
    if selected.sum() == 0:
        return gt_boxes, points

    ii, jj = np.nonzero(selected)
    pick = {}
    for i in set(ii.tolist()):
        pick[i] = rng.choice(jj[ii == i])
    to_swap = list(pick.items())
    elig2 = eligible.copy()
    for i, j in to_swap:
        elig2[i, j] = False
    swapped = []
    for i, j in to_swap:
        cands = np.nonzero(elig2[:, j])[0]
        swapped.append((rng.choice(cands) if cands.size else i, j))

    pairs = [(pyramids[i, j], pyramids[i2, j2])
             for (i, j), (i2, j2) in zip(to_swap, swapped)]
    all_pyrs = np.stack([p for pair in pairs for p in pair])
    masks = points_in_pyramids_mask(points, all_pyrs)
    remain = points[~masks.any(-1)]
    res = []
    for k, (pa, pb) in enumerate(pairs):
        pts_a = points[masks[:, 2 * k]]
        pts_b = points[masks[:, 2 * k + 1]]
        pa15, pb15 = pa.reshape(15), pb.reshape(15)
        new_a = recover(ratios(pts_b, pb15), pa15)
        new_b = recover(ratios(pts_a, pa15), pb15)
        ra, lo_a, hi_a = iratio(pts_a) if len(pts_a) else (None, 0, 0)
        rb, lo_b, hi_b = iratio(pts_b) if len(pts_b) else (None, 0, 0)
        ia = rb * (hi_a - lo_a) + lo_a if rb is not None else \
            np.zeros((0, 1))
        ib = ra * (hi_b - lo_b) + lo_b if ra is not None else \
            np.zeros((0, 1))
        res.append(np.concatenate([new_a, ia], axis=1))
        res.append(np.concatenate([new_b, ib], axis=1))
    points = np.concatenate([remain] + res, axis=0).astype(points.dtype)
    return gt_boxes, points
