"""The port's voxelization (glenet_tpu_torch/ops/voxelize.py) against
glenet_tpu's: every output exact, including overflow past max_voxels (first
-occurrence priority) and past max_points_per_voxel."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

from glenet_tpu.ops import voxelize as jvox  # noqa: E402

from glenet_tpu_torch.ops import voxelize as tvox  # noqa: E402

PC_RANGE = (0.0, -8.0, -1.2, 16.0, 8.0, 1.2)
VOXEL = (0.5, 0.5, 0.1)


def _points(seed, n):
    r = np.random.RandomState(seed)
    pts = np.zeros((n, 4), np.float32)
    # some out of range on every axis, clustered so voxels overflow
    pts[:, 0] = r.uniform(-1, 17, n)
    pts[:, 1] = r.uniform(-9, 9, n)
    pts[:, 2] = r.uniform(-1.4, 1.4, n)
    pts[: n // 4, :3] = pts[0, :3] + r.normal(0, 0.05, (n // 4, 3))
    pts[:, 3] = r.uniform(0, 1, n)
    mask = r.rand(n) > 0.1
    return pts, mask


@pytest.mark.parametrize('max_voxels,max_pts', [(512, 5), (64, 3), (2048, 5)])
def test_voxelize_matches(max_voxels, max_pts):
    pts, mask = _points(max_voxels, 1024)
    grid = tvox.compute_grid_size(PC_RANGE, VOXEL)
    assert grid == jvox.compute_grid_size(PC_RANGE, VOXEL)
    ref = jvox.voxelize(pts, mask, voxel_size=VOXEL, pc_range=PC_RANGE,
                        grid_size=grid, max_voxels=max_voxels,
                        max_points_per_voxel=max_pts)
    got = tvox.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), VOXEL,
                        PC_RANGE, grid, max_voxels, max_pts)
    for k in ('voxel_coords', 'voxel_mask', 'voxel_num_points',
              'point_voxel_idx', 'voxels'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    if max_voxels == 64:
        assert bool(np.asarray(ref['voxel_mask']).all()), 'overflow case'
