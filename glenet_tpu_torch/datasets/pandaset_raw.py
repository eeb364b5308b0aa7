"""Pandaset info building (the port's own copy of
glenet_tpu/datasets/pandaset_raw.py, numpy only).

Every geometry step is plain numpy, so it runs without the devkit;
`create_pandaset_infos` is the thin seam over the pandaset devkit (and
pandas), raising a RuntimeError naming it when it is absent.

  - the info schema {sequence, frame_idx, lidar_path, cuboids_path} of
    pandaset_infos_{split}.pkl (the reference's get_infos and
    create_pandaset_infos);
  - world -> ego through the frame's pose (position and a w, x, y, z
    heading quaternion; the devkit's lidar_points_to_ego applies
    R(q)^T (p - t));
  - ego -> "normative" axes (x forward, y left): x and y swapped, then the
    new y negated;
  - cuboids: centres through the same transform, yaw shifted by
    zrot_world_to_ego = atan2(-yx, yy) of the pose-transformed y axis,
    dims dx / dy swapped.

With `extract_frames=True` each frame is also written as a normative
(N, 4) float32 .npy, the points file the PandasetDataset adapter reads
through lidar_path.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .nuscenes_raw import quat_to_rot


def pose_rt(pose):
    """Pandaset pose dict {'position': {x,y,z}, 'heading': {w,x,y,z}} ->
    (R (3,3) world-from-ego rotation, t (3,))."""
    p = pose['position']
    h = pose['heading']
    r = quat_to_rot((h['w'], h['x'], h['y'], h['z']))
    t = np.array([p['x'], p['y'], p['z']], np.float64)
    return r, t


def world_to_ego(points, pose):
    """Devkit lidar_points_to_ego: R(q)^T (p - t)."""
    r, t = pose_rt(pose)
    return (np.asarray(points, np.float64) - t) @ r


def ego_to_normative(pts):
    """Pandaset ego (x right, y forward) -> normative (x forward,
    y left): x_n = y_e, y_n = -x_e."""
    pts = np.asarray(pts)
    out = pts[:, [1, 0, 2]].copy()
    out[:, 1] = -out[:, 1]
    return out


def zrot_world_to_ego(pose):
    """Yaw offset between world and ego frames: the angle of the
    pose-transformed world y axis."""
    y2 = world_to_ego(np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]), pose)
    yaxis = y2[1] - y2[0]
    return float(np.arctan2(-yaxis[0], yaxis[1]))


def points_to_normative(points_xyz, intensity, pose):
    """World-frame lidar points -> normative ego (N, 4) float32."""
    ego = ego_to_normative(world_to_ego(points_xyz, pose))
    return np.concatenate(
        [ego, np.asarray(intensity, np.float64).reshape(-1, 1)],
        axis=1).astype(np.float32)


def cuboids_to_normative(centers, dims_xyz, yaws, pose):
    """World-frame cuboids -> normative ego (M, 7) boxes:
    centers through the point transform, yaw + zrot_world_to_ego, dims
    (dx, dy) swapped."""
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    dims = np.asarray(dims_xyz, np.float64).reshape(-1, 3)
    yaws = np.asarray(yaws, np.float64).reshape(-1)
    ego_c = ego_to_normative(world_to_ego(centers, pose))
    zrot = zrot_world_to_ego(pose)
    out = np.concatenate([
        ego_c,
        dims[:, [1, 0, 2]],                    # ego_dxs=dys, ego_dys=dxs
        (yaws + zrot).reshape(-1, 1)], axis=1)
    return out.astype(np.float32), zrot


def build_sequence_infos(root_path, seq, n_frames):
    """Reference-schema info dicts for one sequence."""
    if n_frames > 100:
        raise ValueError(
            f'sequence {seq} has {n_frames} frames (> 100); the '
            'reference assumes <= 100 frames per sequence')
    root = Path(root_path)
    return [{
        'sequence': seq,
        'frame_idx': ii,
        'lidar_path': str(root / 'dataset' / seq / 'lidar'
                          / f'{ii:02d}.pkl.gz'),
        'cuboids_path': str(root / 'dataset' / seq / 'annotations'
                            / 'cuboids' / f'{ii:02d}.pkl.gz'),
    } for ii in range(n_frames)]


def create_pandaset_infos(data_path, save_path, training_categories=None,
                          lidar_device=0, val_ratio=0.2,
                          extract_frames=False):
    """Devkit seam (reference create_pandaset_infos): writes
    pandaset_infos_{train,val}.pkl with the reference schema; with
    `extract_frames` also materializes normative .npy point files + gt
    arrays per frame (the contract our adapter's lidar_path consumes).
    Requires the `pandaset` devkit + pandas."""
    try:
        import pandas as pd  # noqa: F401
        import pandaset as ps
    except ImportError as e:                      # pragma: no cover
        raise RuntimeError(
            'create_pandaset_infos needs the pandaset devkit '
            '(pip install pandaset) + pandas') from e

    data_path = Path(data_path)
    save_path = Path(save_path)
    dataset = ps.DataSet(str(data_path))
    sequences = sorted(dataset.sequences())
    n_val = max(1, int(len(sequences) * val_ratio))
    split_seqs = {'train': sequences[:-n_val], 'val': sequences[-n_val:]}

    save_path.mkdir(parents=True, exist_ok=True)
    counts = {}
    for split, seqs in split_seqs.items():
        infos = []
        for seq in seqs:
            s = dataset[seq]
            s.load_lidar()
            seq_infos = build_sequence_infos(data_path, seq,
                                             len(s.lidar.data))
            if extract_frames:
                s.lidar._load_poses()
                for info in seq_infos:
                    ii = info['frame_idx']
                    frame = s.lidar.data[ii]
                    pose = s.lidar.poses[ii]
                    if lidar_device != -1:
                        frame = frame[frame['d'] == lidar_device]
                    pts = points_to_normative(
                        frame[['x', 'y', 'z']].to_numpy(),
                        frame['i'].to_numpy(), pose)
                    out = save_path / 'extracted' / seq
                    out.mkdir(parents=True, exist_ok=True)
                    np.save(out / f'{ii:02d}.npy', pts)
                    info['lidar_path'] = str(
                        Path('extracted') / seq / f'{ii:02d}.npy')
            infos.extend(seq_infos)
            del dataset._sequences[seq]
        (save_path / f'pandaset_infos_{split}.pkl').write_bytes(
            pickle.dumps(infos))
        counts[split] = len(infos)
    return counts
