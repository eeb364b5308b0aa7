"""Synthetic Waymo-like LiDAR frames, and a cell's pool of inputs.

Frozen copy of `glenet_tpu_torch/utils/synthetic.py` (`_place_vehicles`,
`waymo_frame`, `_model_points`, `waymo_scene_batches`) as the port had it
when the benchmark was written, so that a later change to the port cannot
move the yardstick.  Frames hold 170000 points with 5 features (x, y, z,
intensity, elongation) and Vehicle boxes: 26.5 Vehicles a frame on average
(Sun et al., CVPR 2020, the Waymo Open Dataset).

Two changes from the original:
  - every seed gets the same multiset of Vehicle counts, spread evenly over
    the traffic's range, in an order drawn from the seed: a seed changes
    which frame carries which load and never the load of the pool, so runs
    on different seeds do the same work;
  - numpy's generator is seeded from any integer (seeds pass 2**31)
    through a SeedSequence.
"""
from __future__ import annotations

import numpy as np

VEHICLE_SIZE = ((4.2, 5.2), (1.8, 2.3), (1.5, 1.9))   # l, w, h ranges


def rng_for(seed: int, stream: int = 0) -> np.random.RandomState:
    """A RandomState drawn from (seed, stream) for any integer seed."""
    words = np.random.SeedSequence([int(seed) % 2 ** 64, stream])
    return np.random.RandomState(words.generate_state(4))


def rotate_z(points, angle):
    """(N, 3) points rotated by `angle` about +z (row-vector convention)."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    return points @ rot


def place_vehicles(rng, n, radius=(4.0, 70.0)):
    """n non-overlapping Vehicle boxes over 360 degrees, 4-70 m away, on the
    ground (z = 0 in Waymo's vehicle frame)."""
    boxes = []
    while len(boxes) < n:
        r, t = rng.uniform(*radius), rng.uniform(-np.pi, np.pi)
        x, y = r * np.cos(t), r * np.sin(t)
        if any(np.hypot(x - b[0], y - b[1]) < 6.0 for b in boxes):
            continue
        l, w, h = (rng.uniform(*v) for v in VEHICLE_SIZE)
        boxes.append([x, y, h / 2, l, w, h, rng.uniform(-np.pi, np.pi)])
    return np.array(boxes, np.float32).reshape(-1, 7)


def waymo_frame(rng, n_vehicles, n_points, grid_range, radius=(4.0, 70.0)):
    """One frame: points (n_points, 6) [x y z intensity elongation NLZ] over
    360 degrees out to the grid's range, raw intensity before tanh, 2% of
    the points in a no-label zone (flag 1, the rest -1); n_vehicles boxes
    (M, 7) with a cluster of points in each, fewer the farther they are.
    The ground's density falls as 1 / range, as a spinning lidar's does."""
    boxes = place_vehicles(rng, n_vehicles, radius)
    parts = []
    for b in boxes:
        k = int(3000 * n_points / 170_000
                * np.exp(-np.hypot(b[0], b[1]) / 25.0)) + 30
        local = rng.uniform(-0.5, 0.5, (k, 3)) * b[3:6]
        parts.append(rotate_z(local, b[6]) + b[:3])
    n_rest = max(n_points - sum(len(p) for p in parts), 0)
    r = rng.uniform(3.0, grid_range * np.sqrt(2), n_rest)
    t = rng.uniform(-np.pi, np.pi, n_rest)
    z = np.where(rng.uniform(0, 1, n_rest) < 0.75,
                 rng.normal(0.0, 0.05, n_rest), rng.uniform(0.0, 4.0, n_rest))
    parts.append(np.stack([r * np.cos(t), r * np.sin(t), z], 1))
    xyz = np.concatenate(parts)[:n_points]
    feats = np.stack([rng.exponential(0.3, len(xyz)),
                      rng.uniform(0, 1, len(xyz)),
                      np.where(rng.uniform(0, 1, len(xyz)) < 0.02, 1.0,
                               -1.0)], 1)
    return np.concatenate([xyz, feats], 1).astype(np.float32), boxes


def model_points(raw, n_points, grid_range, z_range):
    """A frame's raw points as the detector takes them: those out of the
    no-label zone, tanh of the intensity (WaymoDataset.get_lidar), inside
    the range, padded to n_points with a mask."""
    pts = raw[raw[:, 5] == -1][:, :5].copy()
    pts[:, 3] = np.tanh(pts[:, 3])
    keep = ((np.abs(pts[:, :2]) <= grid_range).all(1)
            & (pts[:, 2] >= z_range[0]) & (pts[:, 2] <= z_range[1]))
    pts = pts[keep][:n_points]
    out = np.zeros((n_points, 5), np.float32)
    out[:len(pts)] = pts
    mask = np.zeros(n_points, bool)
    mask[:len(pts)] = True
    return out, mask


def vehicle_counts(n_frames, lo, hi):
    """The pool's multiset of Vehicle counts: n_frames values spread evenly
    over [lo, hi] (mean (lo + hi) / 2), the same for every seed."""
    return np.rint(np.linspace(lo, hi, n_frames)).astype(int)


def make_pool(traffic, seed):
    """The cell's pool of inputs, drawn from `seed`: numpy arrays with a
    leading (pool, batch) shape: points (.., P, 5), points_mask; with
    `labels` also gt_boxes (.., max_gt, 8) (class 1), gt_mask and
    gt_uncertainty (.., max_gt, 7), the label variances a CVAE would give,
    uniform in traffic['label_variance']."""
    n, b = int(traffic['pool']), int(traffic['batch'])
    p, max_gt = int(traffic['points']), int(traffic['max_gt'])
    grid_range, z_range = float(traffic['range']), traffic['z_range']
    rng = rng_for(seed)
    counts = rng.permutation(vehicle_counts(n * b, *traffic['vehicles']))
    pts = np.zeros((n, b, p, 5), np.float32)
    pmask = np.zeros((n, b, p), bool)
    gt = np.zeros((n, b, max_gt, 8), np.float32)
    gt_mask = np.zeros((n, b, max_gt), bool)
    unc = np.ones((n, b, max_gt, 7), np.float32)
    var_lo, var_hi = traffic.get('label_variance', (0.01, 0.2))
    radius = traffic.get('vehicle_radius', (4.0, 70.0))
    for i in range(n):
        for j in range(b):
            raw, boxes = waymo_frame(rng, int(counts[i * b + j]), p,
                                     grid_range, radius)
            pts[i, j], pmask[i, j] = model_points(raw, p, grid_range, z_range)
            k = min(len(boxes), max_gt)
            gt[i, j, :k, :7], gt[i, j, :k, 7] = boxes[:k], 1
            gt_mask[i, j, :k] = True
            unc[i, j, :k] = rng.uniform(var_lo, var_hi, (k, 7))
    pool = {'points': pts, 'points_mask': pmask}
    if traffic.get('labels', False):
        pool.update(gt_boxes=gt, gt_mask=gt_mask, gt_uncertainty=unc)
    return pool
