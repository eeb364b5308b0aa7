"""GLENet CVAE datasets (torch counterpart of glenet_tpu/cvae/dataset.py):
per-object gt-database crops with K-fold splits, occlusion synthesis,
geometric augmentation and anchor normalisation.

  - KittiGtDataset: Car (+ Van with ENABLE_SIMILAR_TYPE) crops of
    kitti_dbinfos_train.pkl, a 10-fold split selected by FOLD_IDX;
  - occlusion: the crop and a dense (> 1000 points) donor object are
    projected to a 48 x 512 range view, and crop points inside the donor's
    convex hull are dropped;
  - flip (y), global scale, rotation about the box centre, xy shift;
  - normalisation by the Car anchor (3.9, 1.6, 1.56): xy and the box
    centre over the BEV diagonal, z over dz_a, log size ratios;
  - resampling to exactly 512 points with replacement;
  - per object: points (512, C), gt_boxes (7,), gt_boxes_input (8,) with
    (sin h, cos h).

The numpy draws come in the JAX package's order, from the dataset's own
unseeded RandomState (`self.rng`), so two datasets given the same seeded
RandomState give the same items.  The K-fold split is the port's own
(`kfold_split`): scikit-learn's KFold(shuffle=True, random_state=42)
written out, because the machine with the card has no scikit-learn.

Batches are numpy dicts with static shapes: points (B, 512, C), gt_boxes
(B, 7), gt_boxes_input (B, 8).
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ..utils import calibration_kitti
from ..utils.calibration_kitti import (  # noqa: F401 (part of this API)
    get_road_plane, put_boxes_on_road_planes)

ANCHOR = (3.9, 1.6, 1.56)
RV_WIDTH, RV_HEIGHT = 512, 48
NUM_POINTS = 512
KFOLD_SEED = 42


def kfold_split(n: int, n_splits: int, fold: int):
    """(train indices, val indices) of fold `fold` of `n` items, both in
    ascending order, as KFold(n_splits, shuffle=True,
    random_state=KFOLD_SEED) gives them: RandomState(KFOLD_SEED) shuffles
    arange(n), the shuffled order is cut into n_splits consecutive folds of
    n // n_splits items, the first n % n_splits folds one larger."""
    if not 2 <= n_splits <= n:
        raise ValueError(f'cannot split {n} items into {n_splits} folds')
    order = np.arange(n)
    np.random.RandomState(KFOLD_SEED).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[:n % n_splits] += 1
    start = int(sizes[:fold].sum())
    val = np.zeros(n, bool)
    val[order[start:start + sizes[fold]]] = True
    return np.flatnonzero(~val), np.flatnonzero(val)


def scan_to_rv(scan, rv_width=RV_WIDTH, rv_height=RV_HEIGHT,
               fov_up_deg=3.0, fov_down_deg=-25.0):
    """(N, 3+) points -> (N, 3) [u, v, range] range-view pixel coords."""
    fov_up = fov_up_deg / 180.0 * np.pi
    fov_down = fov_down_deg / 180.0 * np.pi
    r = np.sqrt((scan[:, :3] ** 2).sum(axis=1))
    with np.errstate(divide='ignore', invalid='ignore'):
        u = 0.5 * (1 - np.arctan(scan[:, 1] / scan[:, 0]) / np.pi) * rv_width
        v = (1 - (np.arcsin(scan[:, 2] / r) + abs(fov_down))
             / (fov_up + abs(fov_down))) * rv_height
    u = np.clip(np.floor(np.nan_to_num(u)), 0, rv_width - 1)
    v = np.clip(np.floor(np.nan_to_num(v)), 0, rv_height - 1)
    return np.stack([u, v, r]).T


def points_in_convex_hull_2d(query, hull_pts):
    """query (N, 2) vs the convex hull of hull_pts (M, 2) -> (N,) bool."""
    from scipy.spatial import ConvexHull, QhullError
    try:
        hull = ConvexHull(hull_pts)
    except (QhullError, ValueError):
        return np.zeros(len(query), bool)
    # hull.equations: (F, 3) rows [a, b, c] with a*x + b*y + c <= 0 inside
    eq = hull.equations
    return (query @ eq[:, :2].T + eq[:, 2][None, :] <= 1e-9).all(axis=1)


def _occlusion_moves(rv_sample, rv_dense):
    """The ranges of the donor's (x, y) moves in the range view."""
    sx_min, sx_max = rv_sample[:, 0].min(), rv_sample[:, 0].max()
    sy_min, sy_max = rv_sample[:, 1].min(), rv_sample[:, 1].max()
    dx_min, dx_max = rv_dense[:, 0].min(), rv_dense[:, 0].max()
    dy_min = rv_dense[:, 1].min()
    return (0.7 * sx_min + 0.3 * sx_max - dx_max,
            0.3 * sx_min + 0.7 * sx_max - dx_min,
            0.9 * sy_min + 0.1 * sy_max - dy_min,
            0.5 * sy_min + 0.5 * sy_max - dy_min)


class KittiGtDataset:
    """Per-object crop dataset for CVAE training and prediction."""
    anchor = ANCHOR
    num_point_features = 4
    default_folds = 10

    def __init__(self, dataset_cfg, class_names=('Car',), training=True,
                 root_path=None, logger=None, infos=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.root_path = Path(root_path if root_path is not None
                              else dataset_cfg.DATA_PATH)
        self.logger = logger
        self.enable_similar_type = dataset_cfg.get('ENABLE_SIMILAR_TYPE',
                                                   False)
        used_infos = list(infos) if infos is not None else self._read_db()
        if 'FOLD_IDX' in dataset_cfg:
            train_idx, val_idx = kfold_split(
                len(used_infos),
                dataset_cfg.get('NUM_FOLDS', self.default_folds),
                dataset_cfg.FOLD_IDX)
            self.infos = [used_infos[i]
                          for i in (train_idx if training else val_idx)]
        else:
            self.infos = used_infos

        self.dense_gt_infos = [x for x in self.infos
                               if x.get('num_points_in_gt', 0) > 1000]
        self.linear_anneal = 0.0
        self.force_ratio = dataset_cfg.get('FORCE_RATIO', 0.0)
        self.force_num = dataset_cfg.get('FORCE_NUM', 0)
        self.enable_flip = dataset_cfg.get('ENABLE_FLIP', False)
        self.scale_range = dataset_cfg.get('RANDOM_SCALE_RANGE', [1.0, 1.0])
        self.angle_rot_max = dataset_cfg.get('ANGLE_ROT_MAX', 0.0)
        self.pos_shift_max = dataset_cfg.get('POS_SHIFT_MAX', 0.0)
        self.rng = np.random.RandomState()

    def _read_db(self):
        with open(self.root_path / 'kitti_dbinfos_train.pkl', 'rb') as f:
            db = pickle.load(f)
        used = list(db['Car'])
        if self.enable_similar_type and 'Van' in db:
            used.extend(db['Van'])
        return used

    def __len__(self):
        return len(self.infos)

    def _canonicalize(self, info, points):
        """Hook between the occlusion and flip / scale (Waymo's azimuth
        canonicalisation overrides it)."""
        return info, points

    def _frame_key(self, info, index):
        return info['image_idx'], info.get('gt_idx', index)

    def _load_points(self, info):
        path = self.root_path / info['path']
        return np.fromfile(str(path), dtype=np.float32).reshape(
            -1, self.num_point_features)

    # -- occlusion synthesis -------------------------------------------------
    def _donor_scan(self, info, dense_info, dense_points, dense_gt_box):
        """KITTI: the donor on the crop's ray, closer to the sensor, its
        bottom on the road plane; None without calib or plane files."""
        frame_id = info['image_idx']
        calib_path = self.root_path / f'training/calib/{frame_id}.txt'
        plane_path = self.root_path / f'training/planes/{frame_id}.txt'
        calib = calibration_kitti.Calibration(str(calib_path))
        road_plane = get_road_plane(str(plane_path))
        box = np.asarray(info['box3d_lidar'])
        new_c_x, new_c_y = self._donor_centre(box, dense_gt_box)
        dense_gt_box[0], dense_gt_box[1] = new_c_x, new_c_y
        _, mv_height = put_boxes_on_road_planes(
            dense_gt_box[None], road_plane, calib)
        dense_scan = dense_points.copy()
        dense_scan[:, 0] += new_c_x
        dense_scan[:, 1] += new_c_y
        dense_scan[:, 2] += dense_info['box3d_lidar'][2] - mv_height[0]
        return dense_scan

    def _donor_centre(self, box, dense_gt_box):
        scale = self.rng.random() * 0.4 + 0.5
        new_c_x = box[0] * scale
        if new_c_x + dense_gt_box[3] / 2 > box[0] - box[3] / 2:
            new_c_x = box[0] - box[3] / 2 - dense_gt_box[3] / 2
            scale = new_c_x / box[0] if box[0] != 0 else scale
        return new_c_x, box[1] * scale

    def _has_occlusion_inputs(self, info):
        frame_id = info['image_idx']
        return ((self.root_path / f'training/calib/{frame_id}.txt').exists()
                and (self.root_path / f'training/planes/{frame_id}.txt')
                .exists())

    @staticmethod
    def _to_rv(scan):
        return scan_to_rv(scan)

    def occlude_aug(self, info, points, max_num=99999, min_num=1,
                    max_try_time=5):
        if not self.dense_gt_infos or not self._has_occlusion_inputs(info):
            return points
        dense_info = self.dense_gt_infos[
            self.rng.randint(len(self.dense_gt_infos))]
        dense_points = self._load_points(dense_info)
        dense_gt_box = np.array(dense_info['box3d_lidar'], np.float64).copy()

        # crop points back to the scene frame
        scan = points.copy()
        scan[:, :3] += np.asarray(info['box3d_lidar'][:3])
        dense_scan = self._donor_scan(info, dense_info, dense_points,
                                      dense_gt_box)
        rv_sample = self._to_rv(scan)
        rv_dense = self._to_rv(dense_scan)
        if len(rv_dense) == 0 or len(rv_sample) == 0:
            return points
        x_move_min, x_move_max, y_move_min, y_move_max = _occlusion_moves(
            rv_sample, rv_dense)

        rv_d = rv_dense.copy()
        for _ in range(max_try_time + 1):
            x_mv = self.rng.rand() * (x_move_max - x_move_min) + x_move_min
            y_mv = self.rng.rand() * (y_move_max - y_move_min) + y_move_min
            rv_d[:, 0] += x_mv
            rv_d[:, 1] += y_mv
            occluded = points_in_convex_hull_2d(rv_sample[:, :2], rv_d[:, :2])
            reserved = points[~occluded]
            if min_num <= len(reserved) <= max_num:
                return reserved
        return points

    # -- main transform -------------------------------------------------------
    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        points = self._load_points(info)

        if self.training:
            if (self.force_ratio * self.linear_anneal > self.rng.rand()
                    and points.shape[0] > self.force_num):
                points = self.occlude_aug(info, points, max_num=self.force_num,
                                          min_num=1, max_try_time=20)
            elif points.shape[0] > 10:
                points = self.occlude_aug(info, points, max_num=99999,
                                          min_num=1, max_try_time=5)

        info, points = self._canonicalize(info, points)

        flip_mark = False
        noise_scale = 1.0
        if self.training:
            if self.enable_flip:
                flip_mark = bool(self.rng.rand() < 0.5)
                if flip_mark:
                    points[:, 1] = -points[:, 1]
            noise_scale = self.rng.uniform(self.scale_range[0],
                                           self.scale_range[1])
            points[:, :3] *= noise_scale

        if points.shape[0] != 0:
            x_mean, y_mean, z_mean = points[:, :3].mean(axis=0)
        else:
            x_mean = y_mean = z_mean = 0.0

        dxa, dya, dza = self.anchor
        diagonal = np.sqrt(dxa ** 2 + dya ** 2)

        pos_shift = np.zeros(2)
        angle_rot = 0.0
        if self.training:
            angle_rot = (self.rng.rand() - 0.5) / 0.5 * self.angle_rot_max
            pos_shift = (self.rng.rand(2) - 0.5) / 0.5 * self.pos_shift_max
            c, s = np.cos(angle_rot), np.sin(angle_rot)
            rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
            points = np.concatenate(
                [points[:, :3] @ rot, points[:, 3:]], axis=1)

        points = points.copy()
        points[:, 0] = (points[:, 0] - x_mean + pos_shift[0]) / diagonal
        points[:, 1] = (points[:, 1] - y_mean + pos_shift[1]) / diagonal
        points[:, 2] = (points[:, 2] - z_mean) / dza

        if points.shape[0] != 0:
            choice = self.rng.choice(points.shape[0], NUM_POINTS, replace=True)
            points = points[choice]
        else:
            points = np.zeros((NUM_POINTS, self.num_point_features),
                              np.float32)

        frame, gid = self._frame_key(info, index)
        out = {
            'points': points.astype(np.float32),   # (512, C)
            'frame_id': frame,
            'gt_id': gid,
        }
        if 'box3d_lidar' not in info:
            return out

        box = np.array(info['box3d_lidar'], np.float64).copy()
        if flip_mark:
            box[6] = -box[6]
        box[:6] *= noise_scale
        box[0] = (-x_mean + pos_shift[0]) / diagonal
        box[1] = (-y_mean + pos_shift[1]) / diagonal
        box[2] = (-z_mean) / dza
        box[3] = np.log(box[3] / dxa)
        box[4] = np.log(box[4] / dya)
        box[5] = np.log(box[5] / dza)
        box[6] = box[6] + angle_rot

        box7 = box[:7].astype(np.float32)
        box8 = np.concatenate(
            [box7[:6], [np.sin(box7[6]), np.cos(box7[6])]]).astype(np.float32)
        out['gt_boxes'] = box7
        out['gt_boxes_input'] = box8
        return out

    def collate(self, items):
        batch = {
            'points': np.stack([it['points'] for it in items]),
            'frame_id': [it['frame_id'] for it in items],
            'gt_id': [it['gt_id'] for it in items],
        }
        if 'gt_boxes' in items[0]:
            batch['gt_boxes'] = np.stack([it['gt_boxes'] for it in items])
            batch['gt_boxes_input'] = np.stack(
                [it['gt_boxes_input'] for it in items])
        return batch

    def iter_batches(self, batch_size, shuffle=True, seed=None,
                     drop_last=True):
        rng = np.random.RandomState(seed)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            yield self.collate([self[i] for i in idx])


def denormalize_box(box7_norm, anchor=ANCHOR):
    """Invert the anchor normalisation."""
    dxa, dya, dza = anchor
    diagonal = np.sqrt(dxa ** 2 + dya ** 2)
    out = np.asarray(box7_norm, np.float64).copy()
    out[..., 0] *= diagonal
    out[..., 1] *= diagonal
    out[..., 2] *= dza
    out[..., 3] = np.exp(out[..., 3]) * dxa
    out[..., 4] = np.exp(out[..., 4]) * dya
    out[..., 5] = np.exp(out[..., 5]) * dza
    return out


WAYMO_ANCHOR = (4.7, 2.1, 1.7)
WAYMO_RV_WIDTH = 2650
WAYMO_RV_HEIGHT = 64


def scan_to_rv_waymo(scan):
    """Waymo's range view: 2650 x 64, fov +30 / -90 deg."""
    fov_up = 30 / 180.0 * np.pi
    fov_down = -90.0 / 180.0 * np.pi
    r = np.sqrt((scan[:, :3] ** 2).sum(axis=1))
    u = 0.5 * (1 - np.arctan(scan[:, 1] / np.clip(scan[:, 0], 1e-6, None))
               / np.pi) * WAYMO_RV_WIDTH
    v = (1 - (np.arcsin(scan[:, 2] / np.clip(r, 1e-6, None)) + abs(fov_down))
         / (fov_up + abs(fov_down))) * WAYMO_RV_HEIGHT
    u = np.clip(np.floor(u), 0, WAYMO_RV_WIDTH - 1)
    v = np.clip(np.floor(v), 0, WAYMO_RV_HEIGHT - 1)
    return np.stack([u, v, r]).T


class WaymoGtDataset(KittiGtDataset):
    """Waymo per-object crops: 'Vehicle' dbinfos, a 5-fold split, 5-dim
    points (x, y, z, intensity, elongation), the Waymo vehicle anchor
    (4.7, 2.1, 1.7), range-view occlusion without the road-plane fix-up, no
    xy shift, and the azimuth canonicalisation of each crop before the
    normalisation."""
    anchor = WAYMO_ANCHOR
    num_point_features = 5
    default_folds = 5

    def __init__(self, dataset_cfg, class_names=('Vehicle',), training=True,
                 root_path=None, logger=None, infos=None):
        super().__init__(dataset_cfg, class_names, training, root_path,
                         logger, infos)
        self.pos_shift_max = 0.0

    def _read_db(self):
        name = self.dataset_cfg.get(
            'DB_INFO_PATH',
            'waymo_processed_data_v0_5_0_waymo_dbinfos_train_sampled_1.pkl')
        with open(self.root_path / name, 'rb') as f:
            return list(pickle.load(f)['Vehicle'])

    def _frame_key(self, info, index):
        return (f"{info['sequence_name']}#{info['sample_idx']}",
                info.get('gt_idx', index))

    def _has_occlusion_inputs(self, info):
        return True

    def _donor_scan(self, info, dense_info, dense_points, dense_gt_box):
        """Waymo: the donor on the crop's ray at the crop's height."""
        box = np.asarray(info['box3d_lidar'])
        new_c_x, new_c_y = self._donor_centre(box, dense_gt_box)
        dense_scan = dense_points.copy()
        dense_scan[:, 0] += new_c_x
        dense_scan[:, 1] += new_c_y
        dense_scan[:, 2] += box[2]
        return dense_scan

    @staticmethod
    def _to_rv(scan):
        return scan_to_rv_waymo(scan)

    def _canonicalize(self, info, points):
        """Rotate the crop so the object's azimuth falls in a
        quarter-period canonical range (the normalisation is centred on
        the points' mean, so rotating the box-relative crop equals the
        scene-frame rotation)."""
        box = np.asarray(info['box3d_lidar'], np.float64).copy()
        azimuth = np.arctan2(box[0], box[1])
        new_azimuth = (azimuth + np.pi / 4) % (np.pi / 2) - np.pi / 4
        trans_angle = new_azimuth - azimuth
        c, s = np.cos(trans_angle), np.sin(trans_angle)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], points.dtype)
        points = points.copy()
        points[:, :3] = points[:, :3] @ rot
        box[6] = box[6] + trans_angle
        info['box3d_lidar'] = box
        return info, points
