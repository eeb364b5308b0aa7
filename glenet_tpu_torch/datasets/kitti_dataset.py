"""KITTI dataset (the port's own copy of glenet_tpu/datasets/kitti_dataset.py,
host-side numpy): info generation, gt-database creation, training items with
augmentation, fixed-shape collation, and prediction dicts for evaluation.

  - infos: per-frame dict {point_cloud, image, calib, annos{name, truncated,
    occluded, alpha, bbox, dimensions (l, h, w), location, rotation_y,
    score, difficulty, index, gt_boxes_lidar, num_points_in_gt
    [, uncertainty]}};
  - `__getitem__`: FOV crop, lidar-frame gt boxes, `gt_uncertainty` from
    annos['uncertainty'], augmentation, class filtering, range masks, and
    padding to static budgets (MAX_POINTS_PER_SCENE, MAX_GT_PER_SCENE) with
    masks; voxelization happens on the device;
  - `generate_prediction_dicts`: lidar boxes -> camera / image-frame KITTI
    annos;
  - `create_kitti_infos` / `create_groundtruth_database`: data preparation;
  - CaDDN's camera items of GET_ITEM_LIST: `images` (image_2, RGB in
    [0, 1], zero-padded to IMAGE_PAD_TO, default 376 x 1248, with
    `image_shape` the frame's own), `depth_maps` (depth_2, metres,
    padded likewise and block-mean downsampled by downsample_depth_map's
    DOWNSAMPLE_FACTOR), `calib_matricies` (trans_lidar_to_cam,
    trans_cam_to_img) and `gt_boxes2d` (the labels' 2-D boxes, kept
    aligned with gt_boxes through the class and range filters, at the
    feature map's scale, with gt_boxes2d_mask).  The PNGs are read by
    utils/png.py.

Every draw comes from numpy RandomStates in the JAX package's order, so
both packages make the same items for a seed.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from ..ops import host_ops
from ..utils import box_utils, calibration_kitti, object3d_kitti, png
from .augmentor import DataAugmentor
from .processor import find_processor, sample_points_near_far


CAMERA_ITEMS = ('images', 'depth_maps', 'calib_matricies', 'gt_boxes2d')
# the batch keys of the camera items, in collation order
CAMERA_KEYS = ('images', 'depth_maps', 'trans_lidar_to_cam',
               'trans_cam_to_img', 'image_shape', 'gt_boxes2d',
               'gt_boxes2d_mask')


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def calib_to_matricies(calib):
    """Calibration -> (trans_lidar_to_cam (4, 4) = R0 (4 x 4) @ V2C (4 x 4),
    trans_cam_to_img (3, 4) = P2)."""
    v2c = np.vstack([calib.V2C, np.array([0, 0, 0, 1], np.float32)])
    r0 = np.eye(4, dtype=np.float32)
    r0[:3, :3] = calib.R0
    return (r0 @ v2c).astype(np.float32), calib.P2.astype(np.float32)


class KittiDataset:
    METRIC = 'KITTI'

    def __init__(self, dataset_cfg, class_names, training=True,
                 root_path=None, logger=None, seed=None):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.logger = logger
        self.root_path = Path(root_path if root_path is not None
                              else dataset_cfg.DATA_PATH)
        self.split = dataset_cfg.DATA_SPLIT['train' if training else 'test']
        self.root_split_path = self.root_path / (
            'training' if self.split != 'test' else 'testing')

        self.get_item_list = list(dataset_cfg.get('GET_ITEM_LIST',
                                                  ['points']))
        for item in self.get_item_list:
            if item not in ('points',) + CAMERA_ITEMS:
                raise NotImplementedError(
                    f'GET_ITEM_LIST item {item} is not ported yet')

        split_file = self.root_path / 'ImageSets' / f'{self.split}.txt'
        self.sample_id_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists() else None)

        self.kitti_infos = []
        mode = 'train' if training else 'test'
        for info_path in dataset_cfg.INFO_PATH[mode]:
            path = self.root_path / info_path
            if path.exists():
                with open(str(path), 'rb') as f:
                    self.kitti_infos.extend(pickle.load(f))
        if logger:
            logger.info(f'KITTI {self.split}: {len(self.kitti_infos)} frames')

        self.pc_range = np.asarray(dataset_cfg.POINT_CLOUD_RANGE, np.float32)
        self.max_points = int(dataset_cfg.get('MAX_POINTS_PER_SCENE', 65536))
        self.max_gt = int(dataset_cfg.get('MAX_GT_PER_SCENE', 128))
        self.fov_points_only = dataset_cfg.get('FOV_POINTS_ONLY', False)
        used = dataset_cfg.POINT_FEATURE_ENCODING['used_feature_list']
        src = dataset_cfg.POINT_FEATURE_ENCODING['src_feature_list']
        self.feature_idx = [src.index(u) for u in used]

        proc_names = [p.NAME for p in dataset_cfg.DATA_PROCESSOR]
        self.shuffle_points = training and 'shuffle_points' in proc_names
        sp = find_processor(dataset_cfg, 'sample_points')
        self.num_sample_points = (
            int(sp.NUM_POINTS['train' if training else 'test'])
            if sp is not None else -1)

        dd = find_processor(dataset_cfg, 'downsample_depth_map')
        self.depth_ds_factor = (int(dd.DOWNSAMPLE_FACTOR)
                                if dd is not None else 1)
        # a static image size (KITTI's frames are 370-376 x 1224-1242),
        # divisible by the depth network's stride
        pad_to = dataset_cfg.get('IMAGE_PAD_TO', [376, 1248])
        self.image_pad_to = (int(pad_to[0]), int(pad_to[1]))

        self.augmentor = None
        if training and dataset_cfg.get('DATA_AUGMENTOR', None) is not None:
            self.augmentor = DataAugmentor(
                self.root_path, dataset_cfg.DATA_AUGMENTOR,
                self.class_names, logger, seed=seed)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.kitti_infos)

    # -- raw data accessors ---------------------------------------------------
    def get_lidar(self, idx):
        lidar_file = self.root_split_path / 'velodyne' / f'{idx}.bin'
        return np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 4)

    def get_calib(self, idx):
        return calibration_kitti.Calibration(
            str(self.root_split_path / 'calib' / f'{idx}.txt'))

    def get_label(self, idx):
        return object3d_kitti.get_objects_from_label(
            str(self.root_split_path / 'label_2' / f'{idx}.txt'))

    def get_road_plane(self, idx):
        plane_file = self.root_split_path / 'planes' / f'{idx}.txt'
        if not plane_file.exists():
            return None
        return calibration_kitti.get_road_plane(str(plane_file))

    def get_image(self, idx):
        """image_2 PNG -> (H, W, 3) float32 RGB in [0, 1]."""
        img = png.read_png(self.root_split_path / 'image_2' / f'{idx}.png')
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        return img[..., :3].astype(np.float32) / 255.0

    def get_depth_map(self, idx):
        """depth_2 PNG (uint16, metres x 256) -> (H, W) float32 metres."""
        return png.read_png(self.root_split_path / 'depth_2'
                            / f'{idx}.png').astype(np.float32) / 256.0

    def get_image_shape(self, idx):
        img_file = self.root_split_path / 'image_2' / f'{idx}.png'
        if img_file.exists():
            return np.array(png.png_size(img_file), np.int32)
        return np.array([375, 1242], np.int32)

    def _load_camera_items(self, data_dict, info, sample_idx, calib):
        """Attach the camera items GET_ITEM_LIST names."""
        if 'images' in self.get_item_list:
            data_dict['images'] = self.get_image(sample_idx)
        if 'depth_maps' in self.get_item_list:
            data_dict['depth_maps'] = self.get_depth_map(sample_idx)
        if 'calib_matricies' in self.get_item_list:
            (data_dict['trans_lidar_to_cam'],
             data_dict['trans_cam_to_img']) = calib_to_matricies(calib)
        if 'gt_boxes2d' in self.get_item_list and 'annos' in info:
            annos = info['annos']
            mask = annos['name'] != 'DontCare'
            data_dict['gt_boxes2d'] = np.asarray(
                annos['bbox'], np.float32)[mask]
        return data_dict

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        pts_img, pts_rect_depth = calib.rect_to_img(pts_rect)
        val_flag = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
                    & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0]))
        return val_flag & (pts_rect_depth >= 0)

    # -- training item --------------------------------------------------------
    def __getitem__(self, index):
        info = self.kitti_infos[index]
        sample_idx = info['point_cloud']['lidar_idx']
        calib = self.get_calib(sample_idx)
        points = self.get_lidar(sample_idx)
        img_shape = info['image']['image_shape']
        if self.fov_points_only:
            fov = self.get_fov_flag(
                calib.lidar_to_rect(points[:, :3]), img_shape, calib)
            points = points[fov]

        data_dict = {
            'points': points,
            'frame_id': sample_idx,
            'calib': calib,
        }

        if 'annos' in info:
            annos = info['annos']
            mask = annos['name'] != 'DontCare'
            gt_names = annos['name'][mask]
            gt_boxes_lidar = annos['gt_boxes_lidar'][:len(gt_names)] \
                if 'gt_boxes_lidar' in annos else self._annos_to_lidar(
                    annos, calib, mask)
            unc = annos.get('uncertainty', None)
            if unc is None:
                unc = -np.ones((len(gt_names), 7), np.float32)
            else:
                unc = np.asarray(unc)[mask][:len(gt_names)]
            data_dict.update({
                'gt_boxes': gt_boxes_lidar.astype(np.float32),
                'gt_names': gt_names,
                'gt_uncertainty': unc.astype(np.float32),
                'gt_boxes_mask': np.ones(len(gt_names), bool),
            })
            road_plane = self.get_road_plane(sample_idx)
            if road_plane is not None:
                data_dict['road_plane'] = road_plane
        data_dict = self._load_camera_items(data_dict, info, sample_idx,
                                            calib)
        return self.prepare_data(data_dict)

    @staticmethod
    def _annos_to_lidar(annos, calib, mask):
        loc = annos['location'][mask]
        dims = annos['dimensions'][mask]
        rots = annos['rotation_y'][mask]
        boxes_camera = np.concatenate(
            [loc, dims, rots[..., None]], axis=1).astype(np.float32)
        return box_utils.boxes3d_kitti_camera_to_lidar(boxes_camera, calib)

    def prepare_data(self, data_dict, retry=0):
        """Augment -> class filter -> range mask -> static padding."""
        if self.training and self.augmentor is not None \
                and 'gt_boxes' in data_dict:
            data_dict = self.augmentor(data_dict)

        gt_b2d = data_dict.get('gt_boxes2d')
        if 'gt_boxes' in data_dict:
            keep = np.array([n in self.class_names
                             for n in data_dict['gt_names']], bool)
            gt_boxes = data_dict['gt_boxes'][keep]
            gt_names = data_dict['gt_names'][keep]
            gt_unc = data_dict['gt_uncertainty'][keep] \
                if 'gt_uncertainty' in data_dict \
                else -np.ones((keep.sum(), 7), np.float32)
            if gt_b2d is not None:
                assert len(gt_b2d) == len(keep), (
                    'gt_boxes2d misaligned with gt_boxes: camera configs '
                    'must not use box-adding augmentations (gt_sampling)')
                gt_b2d = gt_b2d[keep]
            # drop boxes outside the range (train only)
            if self.training and len(gt_boxes):
                inside = box_utils.mask_boxes_outside_range_numpy(
                    gt_boxes, self.pc_range, min_num_corners=1)
                gt_boxes, gt_names, gt_unc = (
                    gt_boxes[inside], gt_names[inside], gt_unc[inside])
                if gt_b2d is not None:
                    gt_b2d = gt_b2d[inside]
            if self.training and len(gt_boxes) == 0 and retry < 3 \
                    and len(self.kitti_infos) > 1:
                # no box left: take a random frame instead
                new_index = self.rng.randint(len(self.kitti_infos))
                return self.prepare_data(
                    self._raw_item(new_index), retry=retry + 1)
            classes = np.array(
                [self.class_names.index(n) + 1 for n in gt_names],
                np.float32)
            gt_boxes = np.concatenate(
                [gt_boxes[:, :7], classes[:, None]], axis=1)
        else:
            gt_boxes = np.zeros((0, 8), np.float32)
            gt_unc = np.zeros((0, 7), np.float32)

        points = data_dict['points'][:, self.feature_idx]
        in_range = ((points[:, :3] >= self.pc_range[:3]).all(axis=1)
                    & (points[:, :3] <= self.pc_range[3:6]).all(axis=1))
        points = points[in_range]
        if self.num_sample_points > 0:
            points = sample_points_near_far(
                points, self.num_sample_points, self.rng)
        if self.shuffle_points:
            self.rng.shuffle(points)

        # static padding
        n = min(len(points), self.max_points)
        if len(points) > self.max_points:
            sel = self.rng.choice(len(points), self.max_points, replace=False)
            points = points[sel]
        pts_pad = np.zeros((self.max_points, points.shape[1]), np.float32)
        pts_pad[:n] = points[:n]
        pts_mask = np.zeros(self.max_points, bool)
        pts_mask[:n] = True

        g = min(len(gt_boxes), self.max_gt)
        gt_pad = np.zeros((self.max_gt, 8), np.float32)
        gt_pad[:g] = gt_boxes[:g]
        unc_pad = np.zeros((self.max_gt, 7), np.float32)
        unc_pad[:g] = gt_unc[:g]
        gt_mask = np.zeros(self.max_gt, bool)
        gt_mask[:g] = True

        out = {
            'points': pts_pad,
            'points_mask': pts_mask,
            'gt_boxes': gt_pad,
            'gt_mask': gt_mask,
            'gt_uncertainty': unc_pad,
            'frame_id': data_dict['frame_id'],
        }
        if 'calib' in data_dict:
            out['calib'] = data_dict['calib']
        out.update(self._camera_outputs(data_dict, gt_b2d, g, gt_mask))
        return out

    def _camera_outputs(self, data_dict, gt_b2d, g, gt_mask):
        """The camera items at their static sizes: the image zero-padded
        to IMAGE_PAD_TO with its own shape, the depth map padded likewise
        and block-mean downsampled (so it aligns with the padded image's
        depth logits), the 2-D boxes at the feature map's scale."""
        out = {}
        ph, pw = self.image_pad_to
        if 'images' in data_dict:
            img = data_dict['images']
            assert img.shape[0] <= ph and img.shape[1] <= pw, (
                img.shape, self.image_pad_to)
            img_pad = np.zeros((ph, pw, 3), np.float32)
            img_pad[:img.shape[0], :img.shape[1]] = img
            out['images'] = img_pad
            out['image_shape'] = np.array(img.shape[:2], np.int32)
        if 'depth_maps' in data_dict:
            f = self.depth_ds_factor
            dm = data_dict['depth_maps']
            dm_pad = np.zeros((ph, pw), np.float32)
            dm_pad[:dm.shape[0], :dm.shape[1]] = dm
            out['depth_maps'] = dm_pad.reshape(
                ph // f, f, pw // f, f).mean(axis=(1, 3))
        if 'trans_lidar_to_cam' in data_dict:
            out['trans_lidar_to_cam'] = data_dict['trans_lidar_to_cam']
            out['trans_cam_to_img'] = data_dict['trans_cam_to_img']
        if gt_b2d is not None:
            b2d_pad = np.zeros((self.max_gt, 4), np.float32)
            b2d_pad[:g] = gt_b2d[:g] / float(self.depth_ds_factor)
            out['gt_boxes2d'] = b2d_pad
            out['gt_boxes2d_mask'] = gt_mask
        return out

    def _raw_item(self, index):
        info = self.kitti_infos[index]
        sample_idx = info['point_cloud']['lidar_idx']
        calib = self.get_calib(sample_idx)
        points = self.get_lidar(sample_idx)
        d = {'points': points, 'frame_id': sample_idx, 'calib': calib}
        annos = info.get('annos', None)
        if annos is not None:
            mask = annos['name'] != 'DontCare'
            gt_names = annos['name'][mask]
            d.update({
                'gt_boxes': annos['gt_boxes_lidar'][:len(gt_names)].astype(
                    np.float32),
                'gt_names': gt_names,
                'gt_uncertainty': np.asarray(
                    annos.get('uncertainty',
                              -np.ones((mask.sum(), 7)))[mask][:len(gt_names)],
                    np.float32),
                'gt_boxes_mask': np.ones(len(gt_names), bool),
            })
        return self._load_camera_items(d, info, sample_idx, calib)

    @staticmethod
    def collate_batch(items):
        batch = {}
        for key in ('points', 'points_mask', 'gt_boxes', 'gt_mask',
                    'gt_uncertainty'):
            batch[key] = np.stack([it[key] for it in items])
        for key in CAMERA_KEYS:
            if key in items[0]:
                batch[key] = np.stack([it[key] for it in items])
        batch['frame_id'] = [it['frame_id'] for it in items]
        if 'calib' in items[0]:
            batch['calib'] = [it['calib'] for it in items]
        return batch

    def iter_batches(self, batch_size, shuffle=None, seed=0, drop_last=None,
                     process_rank=0, process_count=1):
        """Collated numpy batches in an order shuffled from `seed` (when
        training).  A short last batch is dropped (training) or filled from
        the start of the order.  With process_count > 1 the process reads
        every process_count-th frame of the order from process_rank on
        (the JAX package's per-host striding)."""
        shuffle = self.training if shuffle is None else shuffle
        drop_last = self.training if drop_last is None else drop_last
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        if process_count > 1:
            order = order[process_rank::process_count]
        n = len(order)
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    break
                idx = np.concatenate(
                    [idx, order[:batch_size - len(idx)]])  # wrap-pad
            yield self.collate_batch([self[i] for i in idx])

    # -- predictions -> KITTI annos -------------------------------------------
    def generate_prediction_dicts(self, batch, preds, output_path=None):
        """preds: fixed-shape predictions (final_boxes (B, K, 7),
        final_scores, final_labels, final_valid), tensors or arrays -> list
        of KITTI-format anno dicts (camera frame)."""
        annos = []
        boxes_all = _numpy(preds['final_boxes'])
        scores_all = _numpy(preds['final_scores'])
        labels_all = _numpy(preds['final_labels'])
        valid_all = _numpy(preds['final_valid'])
        for b in range(boxes_all.shape[0]):
            v = valid_all[b]
            boxes_lidar = boxes_all[b][v]
            scores = scores_all[b][v]
            labels = labels_all[b][v]
            calib = batch['calib'][b]
            image_shape = batch.get('image_shape', [(375, 1242)] * (b + 1))[b]

            if len(boxes_lidar):
                boxes_camera = box_utils.boxes3d_lidar_to_kitti_camera(
                    boxes_lidar, calib)
                boxes_img = box_utils.boxes3d_kitti_camera_to_imageboxes(
                    boxes_camera, calib, image_shape)
                alpha = (-np.arctan2(-boxes_lidar[:, 1], boxes_lidar[:, 0])
                         + boxes_camera[:, 6])
            else:
                boxes_camera = np.zeros((0, 7))
                boxes_img = np.zeros((0, 4))
                alpha = np.zeros(0)

            anno = {
                'name': np.array([self.class_names[int(l) - 1]
                                  for l in labels]),
                'truncated': np.zeros(len(scores)),
                'occluded': np.zeros(len(scores)),
                'alpha': alpha,
                'bbox': boxes_img,
                'dimensions': boxes_camera[:, 3:6],
                'location': boxes_camera[:, 0:3],
                'rotation_y': boxes_camera[:, 6],
                'score': scores,
                'boxes_lidar': boxes_lidar,
                'frame_id': batch['frame_id'][b],
            }
            annos.append(anno)
            if output_path is not None:
                self._write_kitti_txt(anno, output_path)
        return annos

    @staticmethod
    def _write_kitti_txt(anno, output_path):
        path = Path(output_path) / f"{anno['frame_id']}.txt"
        with open(path, 'w') as f:
            for i in range(len(anno['name'])):
                d = anno['dimensions'][i]
                l = anno['location'][i]
                bb = anno['bbox'][i]
                print(f"{anno['name'][i]} 0.0 0 {anno['alpha'][i]:.4f} "
                      f"{bb[0]:.4f} {bb[1]:.4f} {bb[2]:.4f} {bb[3]:.4f} "
                      f"{d[1]:.4f} {d[2]:.4f} {d[0]:.4f} "
                      f"{l[0]:.4f} {l[1]:.4f} {l[2]:.4f} "
                      f"{anno['rotation_y'][i]:.4f} {anno['score'][i]:.4f}",
                      file=f)

    def evaluation(self, det_annos, class_names, device=None):
        """KITTI AP of `det_annos` against this split's labels; the overlaps
        and the matcher run on `device` (the GPU by default)."""
        from ..eval import kitti_eval
        gt_annos = [info['annos'] for info in self.kitti_infos]
        return kitti_eval.get_official_eval_result(
            gt_annos, det_annos, list(class_names), device=device)

    # -- info generation (data preparation) -----------------------------------
    def get_infos(self, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        infos = []
        for sample_idx in (sample_id_list or self.sample_id_list):
            pc_info = {'num_features': 4, 'lidar_idx': sample_idx}
            info = {'point_cloud': pc_info,
                    'image': {'image_idx': sample_idx,
                              'image_shape': self.get_image_shape(sample_idx)}}
            calib = self.get_calib(sample_idx)
            info['calib'] = {'P2': calib.P2, 'R0_rect': calib.R0,
                             'Tr_velo_to_cam': calib.V2C}
            if has_label:
                obj_list = self.get_label(sample_idx)
                annos = {
                    'name': np.array([o.cls_type for o in obj_list]),
                    'truncated': np.array([o.truncation for o in obj_list]),
                    'occluded': np.array([o.occlusion for o in obj_list]),
                    'alpha': np.array([o.alpha for o in obj_list]),
                    'bbox': (np.stack([o.box2d for o in obj_list])
                             if obj_list else np.zeros((0, 4))),
                    'dimensions': np.array(
                        [[o.l, o.h, o.w] for o in obj_list]).reshape(-1, 3),
                    'location': (np.stack([o.loc for o in obj_list])
                                 if obj_list else np.zeros((0, 3))),
                    'rotation_y': np.array([o.ry for o in obj_list]),
                    'score': np.array([o.score for o in obj_list]),
                    'difficulty': np.array([o.level for o in obj_list],
                                           np.int32),
                }
                num_objects = sum(1 for o in obj_list
                                  if o.cls_type != 'DontCare')
                annos['index'] = np.concatenate([
                    np.arange(num_objects),
                    -np.ones(len(obj_list) - num_objects, np.int64)
                ]).astype(np.int64)
                if num_objects:
                    loc = annos['location'][:num_objects]
                    dims = annos['dimensions'][:num_objects]
                    rots = annos['rotation_y'][:num_objects]
                    boxes_camera = np.concatenate(
                        [loc, dims, rots[..., None]], axis=1
                    ).astype(np.float32)
                    annos['gt_boxes_lidar'] = \
                        box_utils.boxes3d_kitti_camera_to_lidar(
                            boxes_camera, calib)
                else:
                    annos['gt_boxes_lidar'] = np.zeros((0, 7), np.float32)
                if count_inside_pts and num_objects:
                    points = self.get_lidar(sample_idx)
                    fov = self.get_fov_flag(
                        calib.lidar_to_rect(points[:, :3]),
                        info['image']['image_shape'], calib)
                    inside = host_ops.points_in_rboxes(
                        points[fov][:, :3], annos['gt_boxes_lidar'])
                    annos['num_points_in_gt'] = np.concatenate([
                        inside.sum(axis=0),
                        -np.ones(len(obj_list) - num_objects)]).astype(np.int32)
                elif count_inside_pts:
                    annos['num_points_in_gt'] = -np.ones(
                        len(obj_list), np.int32)
                info['annos'] = annos
            infos.append(info)
        return infos

    def create_groundtruth_database(self, info_path, used_classes=None,
                                    split='train'):
        database_dir = self.root_path / f'gt_database_{split}' \
            if split != 'train' else self.root_path / 'gt_database'
        db_info_save_path = self.root_path / f'kitti_dbinfos_{split}.pkl'
        database_dir.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(str(info_path), 'rb') as f:
            infos = pickle.load(f)
        for info in infos:
            sample_idx = info['point_cloud']['lidar_idx']
            points = self.get_lidar(sample_idx)
            annos = info['annos']
            names = annos['name']
            gt_boxes = annos['gt_boxes_lidar']
            inside = host_ops.points_in_rboxes(points[:, :3], gt_boxes)
            for i in range(len(gt_boxes)):
                if used_classes is not None and names[i] not in used_classes:
                    continue
                filename = f'{sample_idx}_{names[i]}_{i}.bin'
                gt_points = points[inside[:, i]].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.astype(np.float32).tofile(
                    str(database_dir / filename))
                db_info = {
                    'name': names[i],
                    'path': str((database_dir / filename)
                                .relative_to(self.root_path)),
                    'image_idx': sample_idx,
                    'gt_idx': i,
                    'box3d_lidar': gt_boxes[i],
                    'num_points_in_gt': int(inside[:, i].sum()),
                    'difficulty': int(annos['difficulty'][i]),
                    'bbox': annos['bbox'][i],
                    'score': annos['score'][i],
                }
                all_db_infos.setdefault(names[i], []).append(db_info)
        with open(str(db_info_save_path), 'wb') as f:
            pickle.dump(all_db_infos, f)
        return all_db_infos


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path):
    """Infos of the train and val splits and the train gt database."""
    save_path = Path(save_path)
    # training=False: no augmentor (the gt database does not exist yet)
    dataset = KittiDataset(dataset_cfg, class_names, training=False,
                           root_path=data_path)
    for split in ('train', 'val'):
        dataset.split = split
        dataset.root_split_path = dataset.root_path / 'training'
        split_file = dataset.root_path / 'ImageSets' / f'{split}.txt'
        if not split_file.exists():
            continue
        dataset.sample_id_list = [
            x.strip() for x in open(split_file).readlines()]
        infos = dataset.get_infos(has_label=True, count_inside_pts=True)
        out = save_path / f'kitti_infos_{split}.pkl'
        with open(str(out), 'wb') as f:
            pickle.dump(infos, f)
        print(f'kitti_infos_{split}: {len(infos)} frames -> {out}')
    # gt database from the train infos
    train_info = save_path / 'kitti_infos_train.pkl'
    if train_info.exists():
        dataset.split = 'train'
        dataset.create_groundtruth_database(
            train_info, used_classes=class_names, split='train')


if __name__ == '__main__':
    import sys

    from ..config import cfg_from_yaml_file
    if len(sys.argv) > 1 and sys.argv[1] == 'create_kitti_infos':
        cfg = cfg_from_yaml_file(sys.argv[2])
        create_kitti_infos(
            cfg, class_names=['Car', 'Pedestrian', 'Cyclist'],
            data_path=cfg.DATA_PATH, save_path=cfg.DATA_PATH)
