"""Synthetic inputs and seeded random weights for runs on the card
(chip_smoke.py, profile_predict.py, profile_train.py): no trained GLENet-VR
checkpoint and no KITTI data are in the repository."""
from __future__ import annotations

import numpy as np
import torch

from ..models.detectors import build_detector
from ..models.layers import MaskedBatchNorm

N_POINTS = 32768
MAX_GT_PER_SCENE = 128      # KITTI's gt slots per scene


def make_scene(rng, n_points=N_POINTS):
    """Clustered KITTI-like scene: ground plane + car-sized clusters (the
    generator of the JAX package's tools/bench_model.py)."""
    return _scene_and_clusters(rng, n_points)[0]


def _scene_and_clusters(rng, n_points):
    """make_scene's points and the (x, y) centres of its clusters."""
    centres = []
    n_ground = int(n_points * 0.55)
    pts = np.zeros((n_points, 4), np.float32)
    pts[:n_ground, 0] = rng.uniform(0, 69.12, n_ground)
    pts[:n_ground, 1] = rng.uniform(-39.68, 39.68, n_ground)
    pts[:n_ground, 2] = rng.normal(-1.6, 0.1, n_ground)
    i = n_ground
    while i < n_points:
        n = min(rng.randint(200, 1500), n_points - i)
        cx, cy = rng.uniform(5, 60), rng.uniform(-30, 30)
        centres.append((cx, cy))
        pts[i:i + n, 0] = cx + rng.normal(0, 1.5, n)
        pts[i:i + n, 1] = cy + rng.normal(0, 0.8, n)
        pts[i:i + n, 2] = rng.uniform(-1.6, 0.2, n)
        i += n
    pts[:, 3] = rng.uniform(0, 1, n_points)
    return pts, centres


def scene_batches(n, seed=0, batch=2, device='cuda'):
    """`n` predict requests of `batch` scenes each, drawn in order from one
    RandomState(seed): {'points', 'points_mask'} on `device`."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pts = torch.from_numpy(np.stack([make_scene(rng)
                                         for _ in range(batch)])).to(device)
        out.append({'points': pts,
                    'points_mask': torch.ones(pts.shape[:2], dtype=torch.bool,
                                              device=device)})
    return out


def train_batches(n, seed=0, batch=4, device='cuda', n_points=N_POINTS):
    """`n` training batches of `batch` scenes each, all from one
    RandomState(seed): make_scene's points plus one Car gt box per cluster
    (centre, 3.9 x 1.6 x 1.56 m, bottom at the ground, heading within
    +-0.3 rad of the cluster's long x axis) in MAX_GT_PER_SCENE slots, with
    gt_mask and a positive gt_uncertainty (B, 128, 7) of label variances in
    [0.01, 0.2)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pts = np.zeros((batch, n_points, 4), np.float32)
        gt = np.zeros((batch, MAX_GT_PER_SCENE, 8), np.float32)
        gt_mask = np.zeros((batch, MAX_GT_PER_SCENE), bool)
        unc = np.ones((batch, MAX_GT_PER_SCENE, 7), np.float32)
        for b in range(batch):
            pts[b], centres = _scene_and_clusters(rng, n_points)
            k = min(len(centres), MAX_GT_PER_SCENE)
            gt[b, :k, :2] = centres[:k]
            gt[b, :k, 2:7] = [-1.6 + 1.56 / 2, 3.9, 1.6, 1.56, 0.0]
            gt[b, :k, 6] = rng.uniform(-0.3, 0.3, k)
            gt[b, :k, 7] = 1
            gt_mask[b, :k] = True
            unc[b, :k] = rng.uniform(0.01, 0.2, (k, 7))
        out.append({k: torch.from_numpy(v).to(device) for k, v in (
            ('points', pts), ('points_mask', np.ones(pts.shape[:2], bool)),
            ('gt_boxes', gt), ('gt_mask', gt_mask),
            ('gt_uncertainty', unc))})
    return out


def seeded_detector(cfg, device, seed):
    """Detector with weights drawn from `seed`, BN statistics included (so
    BN is not an identity)."""
    torch.manual_seed(seed)
    det = build_detector(cfg, device='cpu')
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in det.net.modules():
            if isinstance(m, MaskedBatchNorm):
                n = m.weight.shape[0]
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
    if device != 'cpu':
        state = det.net.state_dict()
        det = build_detector(cfg, device=device)
        det.net.load_state_dict(state)
    return det
