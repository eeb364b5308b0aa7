"""Synthetic inputs and seeded random weights for runs on the card
(chip_smoke.py, profile_predict.py, profile_train.py): no trained GLENet-VR
checkpoint and no KITTI data are in the repository."""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from ..models.detectors import build_detector
from ..models.layers import MaskedBatchNorm
from . import box_utils, calibration_kitti, common

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


# ---------------------------------------------------------------------------
# a synthetic data tree in KITTI's layout
# ---------------------------------------------------------------------------

# the calibration of KITTI's raw drives of 2011-09-26 (P0..P3, R0_rect,
# Tr_velo_to_cam, Tr_imu_to_velo), as the dataset's calib files hold it
KITTI_CALIB = """P0: 7.215377e+02 0 6.095593e+02 0 0 7.215377e+02 1.728540e+02 0 0 0 1 0
P1: 7.215377e+02 0 6.095593e+02 -3.875744e+02 0 7.215377e+02 1.728540e+02 0 0 0 1 0
P2: 7.215377e+02 0 6.095593e+02 4.485728e+01 0 7.215377e+02 1.728540e+02 2.163791e-01 0 0 1 2.745884e-03
P3: 7.215377e+02 0 6.095593e+02 -3.395242e+02 0 7.215377e+02 1.728540e+02 2.199936e+00 0 0 1 2.729905e-03
R0_rect: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01
Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 -4.069766e-03 1.480249e-02 7.280733e-04 -9.998902e-01 -7.631618e-02 9.998621e-01 7.523790e-03 1.480755e-02 -2.717806e-01
Tr_imu_to_velo: 9.999976e-01 7.553071e-04 -2.035826e-03 -8.086759e-01 -7.854027e-04 9.998898e-01 -1.482298e-02 3.195559e-01 2.024406e-03 1.482454e-02 9.998881e-01 -7.997231e-01
"""
GROUND_Z = -1.73            # lidar height above the road
IMAGE_SHAPE = (375, 1242)
FOV_HALF_ANGLE = np.radians(35.0)


def _place_cars(rng, n, x_range, y_half):
    """n non-overlapping Car boxes (lidar frame, bottoms on the ground)
    inside the camera's field of view."""
    boxes = []
    while len(boxes) < n:
        x = rng.uniform(*x_range)
        y_max = min(y_half, x * np.tan(FOV_HALF_ANGLE) - 1.5)
        if y_max <= 0:
            continue
        y = rng.uniform(-y_max, y_max)
        if any(np.hypot(x - b[0], y - b[1]) < 5.5 for b in boxes):
            continue
        l, w, h = (rng.uniform(3.4, 4.6), rng.uniform(1.5, 1.9),
                   rng.uniform(1.4, 1.8))
        boxes.append([x, y, GROUND_Z + h / 2, l, w, h,
                      rng.uniform(-np.pi, np.pi)])
    return np.array(boxes, np.float32).reshape(-1, 7)


def _frame_points(rng, boxes, n_points, ground_radius):
    """n_points over 360 degrees: points inside each car, then ground and
    clutter out to ground_radius."""
    parts = []
    for b in boxes:
        k = rng.randint(300, 1500)
        local = rng.uniform(-0.5, 0.5, (k, 3)) * b[3:6]
        xyz = common.rotate_points_along_z_np(local, np.array([b[6]]))
        parts.append(np.concatenate([xyz + b[:3],
                                     rng.uniform(0, 1, (k, 1))], 1))
    n_rest = max(n_points - sum(len(p) for p in parts), 0)
    theta = rng.uniform(-np.pi, np.pi, n_rest)
    r = np.sqrt(rng.uniform(4.0, ground_radius ** 2, n_rest))
    z = np.where(rng.uniform(0, 1, n_rest) < 0.8,
                 GROUND_Z + rng.normal(0, 0.03, n_rest),
                 rng.uniform(GROUND_Z, 1.0, n_rest))
    parts.append(np.stack([r * np.cos(theta), r * np.sin(theta), z,
                           rng.uniform(0, 1, n_rest)], 1))
    return np.concatenate(parts).astype(np.float32)


def write_kitti_tree(root, n_train, n_val, seed=0, n_points=120_000,
                     cars=(10, 18), x_range=(6.0, 55.0), y_half=30.0,
                     ground_radius=70.0):
    """A synthetic data tree in KITTI's layout under `root` (training/
    {velodyne, label_2, calib, planes}, ImageSets/{train, val}.txt): frames
    of `n_points` lidar points over 360 degrees, between cars[0] and
    cars[1] labelled Car boxes in the camera's view plus one DontCare
    region, KITTI's calibration and a flat road plane.  Returns `root`."""
    root = Path(root)
    for sub in ('velodyne', 'label_2', 'calib', 'planes'):
        (root / 'training' / sub).mkdir(parents=True, exist_ok=True)
    (root / 'ImageSets').mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = [f'{i:06d}' for i in range(n_train + n_val)]
    for fid in ids:
        calib_file = root / 'training/calib' / f'{fid}.txt'
        calib_file.write_text(KITTI_CALIB)
        calib = calibration_kitti.Calibration(str(calib_file))
        boxes = _place_cars(rng, rng.randint(cars[0], cars[1] + 1), x_range,
                            y_half)
        pts = _frame_points(rng, boxes, n_points, ground_radius)
        cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
        img = box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib,
                                                           IMAGE_SHAPE)
        alpha = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
        lines = [f'Car 0.00 0 {alpha[i]:.2f} {img[i, 0]:.2f} {img[i, 1]:.2f} '
                 f'{img[i, 2]:.2f} {img[i, 3]:.2f} {cam[i, 4]:.2f} '
                 f'{cam[i, 5]:.2f} {cam[i, 3]:.2f} {cam[i, 0]:.2f} '
                 f'{cam[i, 1]:.2f} {cam[i, 2]:.2f} {cam[i, 6]:.2f}'
                 for i in range(len(boxes))]
        u = rng.uniform(0, IMAGE_SHAPE[1] - 60)
        lines.append(f'DontCare -1 -1 -10 {u:.2f} 170.00 {u + 50:.2f} '
                     f'200.00 -1 -1 -1 -1000 -1000 -1000 -10')
        pts.tofile(str(root / 'training/velodyne' / f'{fid}.bin'))
        (root / 'training/label_2' / f'{fid}.txt').write_text(
            '\n'.join(lines) + '\n')
        (root / 'training/planes' / f'{fid}.txt').write_text(
            '# Plane\nWidth 4\nHeight 1\n0 -1 0 1.65\n')
    (root / 'ImageSets/train.txt').write_text('\n'.join(ids[:n_train]) + '\n')
    (root / 'ImageSets/val.txt').write_text('\n'.join(ids[n_train:]) + '\n')
    return root


WAYMO_DB_INFO = 'waymo_processed_data_v0_5_0_waymo_dbinfos_train_sampled_1.pkl'
# (length, width, height) ranges of the crops' boxes, metres
CROP_SIZES = {'Car': ((3.4, 4.6), (1.5, 1.9), (1.4, 1.8)),
              'Van': ((4.5, 5.5), (1.8, 2.1), (1.9, 2.4)),
              'Vehicle': ((4.2, 5.2), (1.8, 2.3), (1.5, 1.9))}
CROPS_PER_FRAME = 4


def write_crop_database(root, n_car, n_van=0, seed=0, waymo=False):
    """A synthetic gt database under `root` in the layout
    create_groundtruth_database writes, for the CVAE's crop datasets:
    gt_database/<frame>_<name>_<i>.bin crops stored relative to their box
    centre, kitti_dbinfos_train.pkl ({name: [{'path', 'image_idx',
    'gt_idx', 'box3d_lidar', 'num_points_in_gt', 'name'}]}), and
    training/{calib, planes}/<frame>.txt per frame of CROPS_PER_FRAME
    objects, which the occlusion augmentation reads.  Boxes sit on the road
    in the camera's view; point counts per crop are log-normal (median 100,
    about 6% above 1000), so dense donors exist.  That distribution is
    assumed, not fitted to KITTI's num_points_in_gt: host costs that depend
    on crop sizes (the occlusion's, the reads') hold only for it.  With
    waymo=True: n_car 'Vehicle' crops of 5 features (intensity, elongation)
    keyed by 'sequence_name' / 'sample_idx', in WAYMO_DB_INFO.  Returns the
    database dict."""
    root = Path(root)
    (root / 'gt_database').mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = ['Vehicle'] * n_car if waymo else ['Car'] * n_car + ['Van'] * n_van
    names = [names[i] for i in rng.permutation(len(names))]
    n_feat = 5 if waymo else 4
    db = {}
    for k, name in enumerate(names):
        frame, gt_idx = divmod(k, CROPS_PER_FRAME)
        if gt_idx == 0 and not waymo:
            for sub, text in (('calib', KITTI_CALIB),
                              ('planes', '# Plane\nWidth 4\nHeight 1\n'
                                         '0 -1 0 1.65\n')):
                path = root / 'training' / sub / f'{frame:06d}.txt'
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(text)
        x = rng.uniform(5.0, 60.0)
        y = rng.uniform(-1, 1) * x * np.tan(FOV_HALF_ANGLE)
        dims = [rng.uniform(*r) for r in CROP_SIZES[name]]
        box = np.array([x, y, GROUND_Z + dims[2] / 2, *dims,
                        rng.uniform(-np.pi, np.pi)], np.float32)
        n = int(np.clip(rng.lognormal(np.log(100.0), 1.5), 1, 20000))
        local = rng.uniform(-0.5, 0.5, (n, 3)) * box[3:6]
        pts = np.concatenate([
            common.rotate_points_along_z_np(local, np.array([box[6]])),
            rng.uniform(0, 1, (n, n_feat - 3))], 1).astype(np.float32)
        fid = f'{frame:06d}'
        rel = f'gt_database/{fid}_{name}_{gt_idx}.bin'
        pts.tofile(str(root / rel))
        info = {'name': name, 'path': rel, 'gt_idx': gt_idx,
                'box3d_lidar': box, 'num_points_in_gt': n}
        if waymo:
            info.update(sequence_name=f'seq_{frame // 8:04d}',
                        sample_idx=frame % 8)
        else:
            info['image_idx'] = fid
        db.setdefault(name, []).append(info)
    with open(root / (WAYMO_DB_INFO if waymo else 'kitti_dbinfos_train.pkl'),
              'wb') as f:
        pickle.dump(db, f)
    return db


def add_label_variances(root, seed=0, car_class='Car'):
    """Write a label variance in [0.01, 0.2) per box coordinate into the
    infos (annos['uncertainty'], -1 for other classes) and the Car entries
    of the gt database of `root`, in the form the CVAE's uncertainty
    injection gives them, so the KL loss sees positive variances."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    variances = {}
    for name in ('kitti_infos_train.pkl', 'kitti_infos_val.pkl'):
        with open(root / name, 'rb') as f:
            infos = pickle.load(f)
        for info in infos:
            annos = info['annos']
            unc = np.full((len(annos['name']), 7), -1.0)
            for i, n in enumerate(annos['name']):
                if n == car_class:
                    unc[i] = rng.uniform(0.01, 0.2, 7)
                    variances[(info['image']['image_idx'], i)] = unc[i]
            annos['uncertainty'] = unc
        with open(root / name, 'wb') as f:
            pickle.dump(infos, f)
    with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
        db_infos = pickle.load(f)
    for info in db_infos.get(car_class, []):
        info['uncertainty'] = variances[(info['image_idx'], info['gt_idx'])]
    with open(root / 'kitti_dbinfos_train.pkl', 'wb') as f:
        pickle.dump(db_infos, f)
