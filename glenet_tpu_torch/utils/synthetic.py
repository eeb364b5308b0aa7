"""Synthetic inputs and seeded random weights for runs on the card
(chip_smoke.py, profile_predict.py): no trained GLENet-VR checkpoint and no
KITTI data are in the repository."""
from __future__ import annotations

import numpy as np
import torch

from ..models.detectors import build_detector
from ..models.layers import MaskedBatchNorm

N_POINTS = 32768


def make_scene(rng, n_points=N_POINTS):
    """Clustered KITTI-like scene: ground plane + car-sized clusters (the
    generator of the JAX package's tools/bench_model.py)."""
    n_ground = int(n_points * 0.55)
    pts = np.zeros((n_points, 4), np.float32)
    pts[:n_ground, 0] = rng.uniform(0, 69.12, n_ground)
    pts[:n_ground, 1] = rng.uniform(-39.68, 39.68, n_ground)
    pts[:n_ground, 2] = rng.normal(-1.6, 0.1, n_ground)
    i = n_ground
    while i < n_points:
        n = min(rng.randint(200, 1500), n_points - i)
        cx, cy = rng.uniform(5, 60), rng.uniform(-30, 30)
        pts[i:i + n, 0] = cx + rng.normal(0, 1.5, n)
        pts[i:i + n, 1] = cy + rng.normal(0, 0.8, n)
        pts[i:i + n, 2] = rng.uniform(-1.6, 0.2, n)
        i += n
    pts[:, 3] = rng.uniform(0, 1, n_points)
    return pts


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
