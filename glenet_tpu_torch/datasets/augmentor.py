"""Data augmentation of the host pipeline (numpy; the port's own copy of
glenet_tpu/datasets/augmentor.py).

  - gt_sampling (`DataBaseSampler`): per-class sample groups filtered by
    difficulty and point count, BEV-IoU collision rejection against the
    scene's and the already sampled boxes, the road-plane height fix-up,
    removal of the scene's points inside sampled boxes, and each sampled
    object's label `uncertainty` carried along (-1 where the database has
    none);
  - random_world_flip, random_world_rotation, random_world_scaling,
    random_world_translation;
  - random_local_translation, random_local_rotation, random_local_scaling;
  - random_world_frustum_dropout, random_local_frustum_dropout;
  - random_local_pyramid_aug (SE-SSD's pyramid dropout, sparsify, swap);
  - noise_per_object (per-object pose jitter with BEV collision
    rejection, augmentor_utils.noise_per_object);
  - random_image_flip (CaDDN, horizontal): image and depth map mirrored,
    the boxes mirrored through the camera and their headings negated.
    Like glenet_tpu, and unlike the reference, it mirrors gt_boxes2d too,
    so the depth loss's foreground mask stays on the flipped image.

Every draw comes from one numpy RandomState that `DataAugmentor` shares
with its sampler, in the JAX package's order, so the two packages make the
same items for a seed.  `gt_uncertainty` stays row-aligned with `gt_boxes`
through every step (the world frustum dropout filters it with the boxes).
Every unknown name raises NotImplementedError.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..ops import iou3d
from ..utils import box_utils, calibration_kitti
from . import augmentor_utils as au

PORTED = ('gt_sampling', 'random_world_flip', 'random_world_rotation',
          'random_world_scaling', 'random_world_translation',
          'random_local_translation', 'random_local_rotation',
          'random_local_scaling', 'random_world_frustum_dropout',
          'random_local_frustum_dropout', 'random_local_pyramid_aug',
          'noise_per_object', 'random_image_flip')


def _bev_iou_np(boxes_a, boxes_b):
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)))
    return iou3d.boxes_bev_iou_np(boxes_a[:, :7].astype(np.float32),
                                  boxes_b[:, :7].astype(np.float32))


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None,
                 rng=None):
        self.root_path = Path(root_path)
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger
        self.rng = rng if rng is not None else np.random.RandomState()

        self.db_infos = {name: [] for name in class_names}
        for db_info_path in sampler_cfg.DB_INFO_PATH:
            path = self.root_path / db_info_path
            with open(str(path), 'rb') as f:
                infos = pickle.load(f)
                for cur_class in class_names:
                    if cur_class in infos:
                        self.db_infos[cur_class].extend(infos[cur_class])

        for func_name, val in sampler_cfg.PREPARE.items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        self.sample_class_num = {}
        for x in sampler_cfg.SAMPLE_GROUPS:
            class_name, sample_num = x.split(':')
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = int(sample_num)
            self.sample_groups[class_name] = {
                'sample_num': int(sample_num),
                'pointer': len(self.db_infos[class_name]),
                'indices': np.arange(len(self.db_infos[class_name])),
            }
        self.use_road_plane = sampler_cfg.get('USE_ROAD_PLANE', False)
        self.limit_whole_scene = sampler_cfg.get('LIMIT_WHOLE_SCENE', False)

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        return {key: [info for info in dinfos
                      if info.get('difficulty', 0) not in removed_difficulty]
                for key, dinfos in db_infos.items()}

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(':')
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [info for info in db_infos[name]
                                  if info['num_points_in_gt'] >= min_num]
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_group):
        """Round-robin over a permutation, drawn anew when it runs out."""
        sample_num = sample_group['sample_num']
        pointer, indices = sample_group['pointer'], sample_group['indices']
        if pointer >= len(self.db_infos[class_name]):
            indices = self.rng.permutation(len(self.db_infos[class_name]))
            pointer = 0
        sampled = [self.db_infos[class_name][idx]
                   for idx in indices[pointer:pointer + sample_num]]
        sample_group['pointer'] = pointer + sample_num
        sample_group['indices'] = indices
        return sampled

    def add_sampled_boxes_to_scene(self, data_dict, sampled_gt_boxes,
                                   total_valid_sampled_dict):
        gt_boxes_mask = data_dict['gt_boxes_mask']
        gt_boxes = data_dict['gt_boxes'][gt_boxes_mask]
        gt_names = data_dict['gt_names'][gt_boxes_mask]
        gt_uncertainty = data_dict.get('gt_uncertainty', None)
        if gt_uncertainty is not None:
            gt_uncertainty = gt_uncertainty[gt_boxes_mask]
        points = data_dict['points']

        if self.use_road_plane and 'calib' in data_dict \
                and 'road_plane' in data_dict:
            sampled_gt_boxes, mv_height = \
                calibration_kitti.put_boxes_on_road_planes(
                    sampled_gt_boxes, data_dict['road_plane'],
                    data_dict['calib'])
        else:
            mv_height = np.zeros(len(sampled_gt_boxes))

        obj_points_list = []
        keep_sampled = []
        for idx, info in enumerate(total_valid_sampled_dict):
            file_path = self.root_path / info['path']
            if not file_path.exists():
                continue
            obj_points = np.fromfile(
                str(file_path), dtype=np.float32).reshape(
                    -1, self.sampler_cfg.NUM_POINT_FEATURES).copy()
            obj_points[:, :3] += sampled_gt_boxes[idx][:3]
            obj_points[:, 2] -= mv_height[idx]
            obj_points_list.append(obj_points)
            keep_sampled.append(idx)

        if not keep_sampled:
            return data_dict
        keep_sampled = np.array(keep_sampled)
        sampled_gt_boxes = sampled_gt_boxes[keep_sampled]
        sampled_infos = [total_valid_sampled_dict[i] for i in keep_sampled]
        sampled_gt_boxes[:, 2] -= mv_height[keep_sampled]
        obj_points = np.concatenate(obj_points_list, axis=0)

        sampled_gt_names = np.array([x['name'] for x in sampled_infos])
        sampled_uncertainty = np.stack([
            np.asarray(x.get('uncertainty', -np.ones(7)), np.float32)
            for x in sampled_infos])

        points = box_utils.remove_points_in_boxes3d(points, sampled_gt_boxes)
        points = np.concatenate([obj_points, points], axis=0)

        data_dict['gt_boxes'] = np.concatenate(
            [gt_boxes, sampled_gt_boxes[:, :gt_boxes.shape[1]]], axis=0)
        data_dict['gt_names'] = np.concatenate([gt_names, sampled_gt_names])
        if gt_uncertainty is not None:
            data_dict['gt_uncertainty'] = np.concatenate(
                [gt_uncertainty, sampled_uncertainty], axis=0)
        data_dict['points'] = points
        data_dict['gt_boxes_mask'] = np.ones(
            len(data_dict['gt_boxes']), bool)
        return data_dict

    def __call__(self, data_dict):
        gt_boxes = data_dict['gt_boxes']
        gt_names = data_dict['gt_names']
        existed_boxes = gt_boxes
        total_valid_sampled_dict = []
        sampled_boxes_all = []

        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = int(np.sum(class_name == gt_names))
                sample_group['sample_num'] = (
                    self.sample_class_num[class_name] - num_gt)
            if sample_group['sample_num'] <= 0:
                continue
            sampled_dict = self.sample_with_fixed_number(
                class_name, sample_group)
            if not sampled_dict:
                continue
            sampled_boxes = np.stack(
                [x['box3d_lidar'] for x in sampled_dict], axis=0
            ).astype(np.float32)

            # collision test: BEV IoU against existing + sampled boxes
            iou1 = np.array(_bev_iou_np(sampled_boxes, existed_boxes))
            iou2 = np.array(_bev_iou_np(sampled_boxes, sampled_boxes))
            iou2[range(len(sampled_boxes)), range(len(sampled_boxes))] = 0
            iou1 = iou1 if iou1.shape[1] > 0 else iou2
            valid = ((iou1.max(axis=1) + iou2.max(axis=1)) == 0).nonzero()[0]
            valid_sampled = [sampled_dict[i] for i in valid]
            valid_boxes = sampled_boxes[valid]
            existed_boxes = np.concatenate([existed_boxes, valid_boxes])
            total_valid_sampled_dict.extend(valid_sampled)
            sampled_boxes_all.append(valid_boxes)

        if total_valid_sampled_dict:
            sampled_gt_boxes = np.concatenate(sampled_boxes_all, axis=0)
            data_dict = self.add_sampled_boxes_to_scene(
                data_dict, sampled_gt_boxes, total_valid_sampled_dict)
        return data_dict


# ---------------------------------------------------------------------------
# world-level augmentations
# ---------------------------------------------------------------------------

def random_image_flip_horizontal(data_dict, rng):
    """With probability 0.5: the image and depth map flipped left-right,
    each box centre mirrored in the image through the calibration (u ->
    W - u at its depth) and back to lidar, its heading negated, and
    gt_boxes2d mirrored (x1, x2 -> W - x2, W - x1)."""
    if rng.rand() < 0.5:
        return data_dict
    image = data_dict['images']
    depth = data_dict['depth_maps']
    calib = data_dict['calib']
    w = image.shape[1]
    data_dict['images'] = np.ascontiguousarray(np.fliplr(image))
    data_dict['depth_maps'] = np.ascontiguousarray(np.fliplr(depth))
    gt = data_dict['gt_boxes'].copy()
    if len(gt):
        img_pts, img_depth = calib.lidar_to_img(gt[:, :3])
        img_pts[:, 0] = w - img_pts[:, 0]
        pts_rect = calib.img_to_rect(img_pts[:, 0], img_pts[:, 1], img_depth)
        gt[:, :3] = calib.rect_to_lidar(pts_rect)
        gt[:, 6] = -gt[:, 6]
        data_dict['gt_boxes'] = gt
    b2d = data_dict.get('gt_boxes2d')
    if b2d is not None and len(b2d):
        b2d = b2d.copy()
        b2d[:, [0, 2]] = w - b2d[:, [2, 0]]
        data_dict['gt_boxes2d'] = b2d
    return data_dict


def random_world_flip(data_dict, along_axis_list, rng):
    gt_boxes = data_dict['gt_boxes']
    points = data_dict['points']
    for axis in along_axis_list:
        if rng.rand() < 0.5:
            continue
        if axis == 'x':       # flip across the x axis: negate y
            gt_boxes = gt_boxes.copy()
            points = points.copy()
            gt_boxes[:, 1] = -gt_boxes[:, 1]
            gt_boxes[:, 6] = -gt_boxes[:, 6]
            points[:, 1] = -points[:, 1]
        elif axis == 'y':
            gt_boxes = gt_boxes.copy()
            points = points.copy()
            gt_boxes[:, 0] = -gt_boxes[:, 0]
            gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
            points[:, 0] = -points[:, 0]
    data_dict['gt_boxes'] = gt_boxes
    data_dict['points'] = points
    return data_dict


def random_world_rotation(data_dict, rot_range, rng):
    angle = rng.uniform(rot_range[0], rot_range[1])
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    points = data_dict['points'].copy()
    points[:, :3] = points[:, :3] @ rot
    gt_boxes = data_dict['gt_boxes'].copy()
    gt_boxes[:, :3] = gt_boxes[:, :3] @ rot
    gt_boxes[:, 6] += angle
    data_dict['points'] = points
    data_dict['gt_boxes'] = gt_boxes
    data_dict['noise_rot'] = angle
    return data_dict


def random_world_scaling(data_dict, scale_range, rng):
    if scale_range[1] - scale_range[0] < 1e-3:
        return data_dict
    scale = rng.uniform(scale_range[0], scale_range[1])
    points = data_dict['points'].copy()
    points[:, :3] *= scale
    gt_boxes = data_dict['gt_boxes'].copy()
    gt_boxes[:, :6] *= scale
    data_dict['points'] = points
    data_dict['gt_boxes'] = gt_boxes
    data_dict['noise_scale'] = scale
    return data_dict


class DataAugmentor:
    def __init__(self, root_path, augmentor_cfg, class_names, logger=None,
                 seed=None):
        self.rng = np.random.RandomState(seed)
        self.queue = []
        disable = set(augmentor_cfg.get('DISABLE_AUG_LIST', []))
        for cfg in augmentor_cfg.AUG_CONFIG_LIST:
            if cfg.NAME in disable:
                continue
            if cfg.NAME not in PORTED:
                raise NotImplementedError(
                    f'augmentor {cfg.NAME} is not ported yet')
            if cfg.NAME == 'gt_sampling':
                self.queue.append(DataBaseSampler(root_path, cfg, class_names,
                                                  logger, rng=self.rng))
            elif cfg.NAME == 'random_image_flip':
                if list(cfg.ALONG_AXIS_LIST) != ['horizontal']:
                    raise NotImplementedError(
                        f'random_image_flip along {cfg.ALONG_AXIS_LIST}')
                self.queue.append(
                    lambda d: random_image_flip_horizontal(d, self.rng))
            elif cfg.NAME == 'random_world_flip':
                axes = cfg.ALONG_AXIS_LIST
                self.queue.append(
                    lambda d, a=axes: random_world_flip(d, a, self.rng))
            elif cfg.NAME == 'random_world_rotation':
                rot = cfg.WORLD_ROT_ANGLE
                if not isinstance(rot, (list, tuple)):
                    rot = [-rot, rot]
                self.queue.append(
                    lambda d, r=rot: random_world_rotation(d, r, self.rng))
            elif cfg.NAME == 'random_world_scaling':
                sc = cfg.WORLD_SCALE_RANGE
                self.queue.append(
                    lambda d, s=sc: random_world_scaling(d, s, self.rng))
            else:
                method = getattr(self, self._METHODS[cfg.NAME])
                self.queue.append(lambda d, c=cfg, m=method: m(d, c))

    _METHODS = {'noise_per_object': '_noise_per_object',
                'random_world_translation': '_world_translation',
                'random_local_translation': '_local_translation',
                'random_local_rotation': '_local_rotation',
                'random_local_scaling': '_local_scaling',
                'random_world_frustum_dropout': '_world_frustum',
                'random_local_frustum_dropout': '_local_frustum',
                'random_local_pyramid_aug': '_pyramid_aug'}

    def _noise_per_object(self, d, cfg):
        valid = d.get('gt_boxes_mask',
                      np.ones(d['gt_boxes'].shape[0], bool))
        rot = cfg.get('GT_ROTATION_NOISE', [-np.pi / 4, np.pi / 4])
        d['gt_boxes'], d['points'] = au.noise_per_object(
            d['gt_boxes'], d['points'], valid_mask=valid,
            rotation_perturb=rot,
            center_noise_std=cfg.get('GT_LOC_NOISE_STD', [1.0, 1.0, 0.5]),
            num_try=int(cfg.get('NUM_TRY', 100)), rng=self.rng)
        return d

    def _world_translation(self, d, cfg):
        """NOISE_TRANSLATE_STD (a normal draw per axis) or, as
        pointpillar_newaugs.yaml writes it, WORLD_TRANSLATION_RANGE (a
        uniform draw per axis)."""
        std = cfg.get('NOISE_TRANSLATE_STD', 0)
        rng_cfg = cfg.get('WORLD_TRANSLATION_RANGE', None)
        if std == 0 and rng_cfg is None:
            return d
        for axis in cfg.ALONG_AXIS_LIST:
            if std:
                d['gt_boxes'], d['points'] = au.random_translation_along_axis(
                    d['gt_boxes'], d['points'], std, axis, self.rng)
            else:
                off = self.rng.uniform(rng_cfg[0], rng_cfg[1])
                ax = au._AXIS[axis]
                d['points'] = d['points'].copy()
                d['gt_boxes'] = d['gt_boxes'].copy()
                d['points'][:, ax] += off
                d['gt_boxes'][:, ax] += off
        return d

    def _local_translation(self, d, cfg):
        for axis in cfg.ALONG_AXIS_LIST:
            d['gt_boxes'], d['points'] = \
                au.random_local_translation_along_axis(
                    d['gt_boxes'], d['points'],
                    cfg.LOCAL_TRANSLATION_RANGE, axis, self.rng)
        return d

    def _local_rotation(self, d, cfg):
        rot = cfg.LOCAL_ROT_ANGLE
        if not isinstance(rot, (list, tuple)):
            rot = [-rot, rot]
        d['gt_boxes'], d['points'] = au.local_rotation(
            d['gt_boxes'], d['points'], rot, self.rng)
        return d

    def _local_scaling(self, d, cfg):
        d['gt_boxes'], d['points'] = au.local_scaling(
            d['gt_boxes'], d['points'], cfg.LOCAL_SCALE_RANGE, self.rng)
        return d

    def _world_frustum(self, d, cfg):
        for direction in cfg.DIRECTION:
            d['gt_boxes'], d['points'], keep_b = au.global_frustum_dropout(
                d['gt_boxes'], d['points'], cfg.INTENSITY_RANGE, direction,
                self.rng)
            for key in ('gt_names', 'gt_boxes_mask', 'gt_uncertainty'):
                if key in d:
                    d[key] = d[key][keep_b]
        return d

    def _local_frustum(self, d, cfg):
        for direction in cfg.DIRECTION:
            d['gt_boxes'], d['points'] = au.local_frustum_dropout(
                d['gt_boxes'], d['points'], cfg.INTENSITY_RANGE, direction,
                self.rng)
        return d

    def _pyramid_aug(self, d, cfg):
        gt, pts = d['gt_boxes'], d['points']
        gt, pts, pyr = au.local_pyramid_dropout(gt, pts, cfg.DROP_PROB,
                                                self.rng)
        gt, pts, pyr = au.local_pyramid_sparsify(
            gt, pts, cfg.SPARSIFY_PROB, int(cfg.SPARSIFY_MAX_NUM), self.rng,
            pyramids=pyr)
        d['gt_boxes'], d['points'] = au.local_pyramid_swap(
            gt, pts, cfg.SWAP_PROB, int(cfg.SWAP_MAX_NUM), self.rng,
            pyramids=pyr)
        return d

    def __call__(self, data_dict):
        for aug in self.queue:
            data_dict = aug(data_dict)
        # wrap headings into [-pi, pi)
        gt_boxes = data_dict['gt_boxes'].copy()
        gt_boxes[:, 6] = (gt_boxes[:, 6] + np.pi) % (2 * np.pi) - np.pi
        data_dict['gt_boxes'] = gt_boxes
        return data_dict
