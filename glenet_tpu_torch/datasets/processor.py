"""Host-side DataProcessor steps shared across dataset adapters (the port's
own copy of glenet_tpu/datasets/processor.py).

`sample_points_near_far` is the near/far-aware point sampling of the
`sample_points` step: when subsampling, far points (depth >= 40 m) are
always kept and the rest of the budget is drawn uniformly from near points;
when oversampling, points are repeated by uniform choice.  The result is
shuffled either way.
"""
import numpy as np

NEAR_DEPTH = 40.0


def sample_points_near_far(points, num_points: int, rng):
    """points (N, C) -> (num_points, C)."""
    if num_points == -1 or len(points) == 0:
        return points
    if num_points < len(points):
        depth = np.linalg.norm(points[:, 0:3], axis=1)
        near = np.where(depth < NEAR_DEPTH)[0]
        far = np.where(depth >= NEAR_DEPTH)[0]
        if num_points > len(far):
            near_choice = rng.choice(near, num_points - len(far),
                                     replace=False)
            choice = (np.concatenate([near_choice, far]) if len(far)
                      else near_choice)
        else:
            choice = rng.choice(np.arange(len(points)), num_points,
                                replace=False)
        rng.shuffle(choice)
    else:
        choice = np.arange(len(points), dtype=np.int64)
        if num_points > len(points):
            extra = rng.choice(choice, num_points - len(points),
                               replace=(len(points) < num_points - len(points)))
            choice = np.concatenate([choice, extra])
        rng.shuffle(choice)
    return points[choice]


def find_processor(dataset_cfg, name: str):
    """Return the DATA_PROCESSOR entry with NAME == name, or None."""
    for p in dataset_cfg.get('DATA_PROCESSOR', []) or []:
        if p.NAME == name:
            return p
    return None
