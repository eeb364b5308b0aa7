"""Waymo Open Dataset adapter (the port's own copy of
glenet_tpu/datasets/waymo_dataset.py, host-side numpy), on the processed
layout of `waymo_raw.process_single_sequence`:

  - per-sequence info pkls listed by ImageSets/<split>.txt, subsampled by
    SAMPLED_INTERVAL;
  - per-frame points in `%04d.npy` (N, 6) [x y z intensity elongation
    NLZ], the no-label-zone points masked and the intensity squashed by
    tanh as the JAX package does;
  - `__getitem__`: gt boxes and label variances (annos['uncertainty']),
    augmentation, class filtering, range masks, a shuffle of the points
    when training and padding to MAX_POINTS_PER_SCENE / MAX_GT_PER_SCENE
    with masks (voxelization happens on the device);
  - `generate_prediction_dicts`: lidar-frame boxes, as Waymo's metric
    scores them;
  - `evaluation`: Waymo mAP / mAPH (eval/waymo_eval.py) or, with
    eval_metric='kitti', KITTI AP on the annos turned into KITTI's format;
    the IoUs run on `device` (the GPU by default);
  - `create_groundtruth_database`: crops of every gt box.

Every draw comes from numpy RandomStates in the JAX package's order, so
both packages make the same items for a seed.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..utils import box_utils
from .augmentor import DataAugmentor
from .kitti_dataset import KittiDataset, _numpy


def frame_points(points_all):
    """A processed frame's .npy array -> (N, 5) points [x y z
    tanh(intensity) elongation]: the points outside the no-label zone (NLZ
    flag -1), unless every point has the flag -1 or none has it, as the JAX
    package selects them."""
    if points_all.shape[1] > 5:
        points_all = points_all[points_all[:, 5] == -1][:, :5] \
            if (points_all[:, 5] != -1).any() else points_all[:, :5]
    points_all[:, 3] = np.tanh(points_all[:, 3])
    return points_all


class WaymoDataset:
    METRIC = 'Waymo'

    def __init__(self, dataset_cfg, class_names, training=True,
                 root_path=None, logger=None, seed=None):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.logger = logger
        self.root_path = Path(root_path if root_path is not None
                              else dataset_cfg.DATA_PATH)
        self.data_path = self.root_path / dataset_cfg.get(
            'PROCESSED_DATA_TAG', 'waymo_processed_data')
        self.split = dataset_cfg.DATA_SPLIT['train' if training else 'test']

        split_file = self.root_path / 'ImageSets' / f'{self.split}.txt'
        self.sample_sequence_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists() else [])

        self.infos = []
        self.include_waymo_data()

        self.pc_range = np.asarray(dataset_cfg.POINT_CLOUD_RANGE, np.float32)
        self.max_points = int(dataset_cfg.get('MAX_POINTS_PER_SCENE', 180000))
        self.max_gt = int(dataset_cfg.get('MAX_GT_PER_SCENE', 256))
        used = dataset_cfg.POINT_FEATURE_ENCODING['used_feature_list']
        src = dataset_cfg.POINT_FEATURE_ENCODING['src_feature_list']
        self.feature_idx = [src.index(u) for u in used]

        self.augmentor = None
        if training and dataset_cfg.get('DATA_AUGMENTOR', None) is not None:
            self.augmentor = DataAugmentor(
                self.root_path, dataset_cfg.DATA_AUGMENTOR,
                self.class_names, logger, seed=seed)
        self.rng = np.random.RandomState(seed)

    def include_waymo_data(self):
        interval = int(self.dataset_cfg.get('SAMPLED_INTERVAL', {}).get(
            'train' if self.training else 'test', 1) or 1)
        for seq_name in self.sample_sequence_list:
            seq_stem = Path(seq_name).stem
            info_path = self.data_path / seq_stem / f'{seq_stem}.pkl'
            if not info_path.exists():
                continue
            with open(str(info_path), 'rb') as f:
                self.infos.extend(pickle.load(f))
        if interval > 1:
            self.infos = self.infos[::interval]
        if self.logger:
            self.logger.info(f'Waymo {self.split}: {len(self.infos)} frames')

    def __len__(self):
        return len(self.infos)

    def get_lidar(self, sequence_name, sample_idx):
        """(N, 5) points of a processed frame (frame_points)."""
        path = self.data_path / sequence_name / f'{sample_idx:04d}.npy'
        return frame_points(np.load(str(path)))

    def __getitem__(self, index):
        info = self.infos[index]
        pc_info = info['point_cloud']
        points = self.get_lidar(pc_info['lidar_sequence'],
                                pc_info['sample_idx'])
        data_dict = {'points': points, 'frame_id': info['frame_id']}
        if 'annos' in info:
            annos = info['annos']
            mask = annos['name'] != 'unknown'
            data_dict.update({
                'gt_boxes': annos['gt_boxes_lidar'][mask][:, :7].astype(
                    np.float32),
                'gt_names': annos['name'][mask],
                'gt_uncertainty': np.asarray(
                    annos.get('uncertainty',
                              -np.ones((mask.sum(), 7)))[mask], np.float32),
                'gt_boxes_mask': np.ones(int(mask.sum()), bool),
            })
        return self.prepare_data(data_dict)

    def prepare_data(self, data_dict):
        """Augment -> class filter -> range mask -> shuffle (training) ->
        static padding."""
        if self.training and self.augmentor is not None \
                and 'gt_boxes' in data_dict:
            data_dict = self.augmentor(data_dict)

        if 'gt_boxes' in data_dict:
            keep = np.array([n in self.class_names
                             for n in data_dict['gt_names']], bool)
            gt_boxes = data_dict['gt_boxes'][keep]
            gt_names = data_dict['gt_names'][keep]
            gt_unc = data_dict.get(
                'gt_uncertainty', -np.ones((len(keep), 7), np.float32))[keep]
            classes = np.array([self.class_names.index(n) + 1
                                for n in gt_names], np.float32)
            gt_boxes = np.concatenate(
                [gt_boxes[:, :7], classes[:, None]], axis=1)
        else:
            gt_boxes = np.zeros((0, 8), np.float32)
            gt_unc = np.zeros((0, 7), np.float32)

        points = data_dict['points'][:, self.feature_idx]
        in_range = ((points[:, :3] >= self.pc_range[:3]).all(axis=1)
                    & (points[:, :3] <= self.pc_range[3:6]).all(axis=1))
        points = points[in_range]
        if self.training:
            # the rows in the order RandomState.shuffle (the JAX package's
            # call) gives them, from the same draws: its row-by-row swaps
            # take ~150 ms for a Waymo frame, the gather ~10 ms
            points = points[self.rng.permutation(len(points))]

        n = min(len(points), self.max_points)
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
        return {'points': pts_pad, 'points_mask': pts_mask,
                'gt_boxes': gt_pad, 'gt_mask': gt_mask,
                'gt_uncertainty': unc_pad, 'frame_id': data_dict['frame_id']}

    collate_batch = staticmethod(KittiDataset.collate_batch)
    iter_batches = KittiDataset.iter_batches

    def generate_prediction_dicts(self, batch, preds, output_path=None):
        """Fixed-shape predictions (tensors or arrays) -> one lidar-frame
        anno dict per frame: name, score, boxes_lidar, frame_id."""
        annos = []
        boxes_all = _numpy(preds['final_boxes'])
        scores_all = _numpy(preds['final_scores'])
        labels_all = _numpy(preds['final_labels'])
        valid_all = _numpy(preds['final_valid'])
        for b in range(boxes_all.shape[0]):
            v = valid_all[b]
            annos.append({
                'name': np.array([self.class_names[int(l) - 1]
                                  for l in labels_all[b][v]]),
                'score': scores_all[b][v],
                'boxes_lidar': boxes_all[b][v],
                'frame_id': batch['frame_id'][b],
            })
        return annos

    def evaluation(self, det_annos, class_names, eval_metric='waymo',
                   device=None):
        """Waymo mAP / mAPH of `det_annos` against this split's labels
        (eval/waymo_eval.py), or with eval_metric='kitti' the KITTI AP of
        both in KITTI's format; the IoUs run on `device` (the GPU by
        default)."""
        if eval_metric == 'waymo':
            from ..eval import waymo_eval
            gt_annos = []
            for info in self.infos:
                a = dict(info['annos'])
                a.setdefault('boxes_lidar', a.get('gt_boxes_lidar'))
                gt_annos.append(a)
            return waymo_eval.waymo_evaluation(det_annos, gt_annos,
                                               class_names, device=device)
        from ..eval import kitti_eval
        from .waymo_utils import transform_annos_to_kitti_format
        gt_annos = [transform_annos_to_kitti_format(
            dict(info['annos']), map_name_to_kitti=True)
            for info in self.infos]
        dt_annos = [transform_annos_to_kitti_format(
            dict(a), map_name_to_kitti=True) for a in det_annos]
        kitti_classes = [
            {'Vehicle': 'Car', 'Pedestrian': 'Pedestrian',
             'Cyclist': 'Cyclist'}.get(c, c) for c in class_names]
        return kitti_eval.get_official_eval_result(
            gt_annos, dt_annos, kitti_classes, device=device)

    def create_groundtruth_database(self, used_classes=None):
        """Each gt box's points, relative to its centre, in
        pcdet_gt_database_<split>/ and their dbinfos in
        pcdet_waymo_dbinfos_<split>.pkl."""
        database_dir = self.root_path / f'pcdet_gt_database_{self.split}'
        db_info_path = self.root_path / f'pcdet_waymo_dbinfos_{self.split}.pkl'
        database_dir.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        for info in self.infos:
            pc_info = info['point_cloud']
            points = self.get_lidar(pc_info['lidar_sequence'],
                                    pc_info['sample_idx'])
            annos = info['annos']
            gt_boxes = annos['gt_boxes_lidar'][:, :7]
            names = annos['name']
            inside = box_utils.points_in_boxes_np(points[:, :3], gt_boxes)
            for i in range(len(gt_boxes)):
                if used_classes is not None and names[i] not in used_classes:
                    continue
                filename = (f"{pc_info['lidar_sequence']}_"
                            f"{pc_info['sample_idx']}_{names[i]}_{i}.bin")
                gt_points = points[inside[:, i]].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.astype(np.float32).tofile(
                    str(database_dir / filename))
                all_db_infos.setdefault(names[i], []).append({
                    'name': names[i],
                    'path': str((database_dir / filename)
                                .relative_to(self.root_path)),
                    'image_idx': info['frame_id'], 'gt_idx': i,
                    'box3d_lidar': gt_boxes[i],
                    'num_points_in_gt': int(inside[:, i].sum()),
                    'difficulty': int(annos.get(
                        'difficulty', np.zeros(len(gt_boxes)))[i]),
                })
        with open(str(db_info_path), 'wb') as f:
            pickle.dump(all_db_infos, f)
        return all_db_infos


def create_waymo_infos(*args, **kwargs):
    """Raw TFRecords -> info pkl + npy per sequence (waymo_raw.py; needs
    the waymo-open-dataset SDK and tensorflow)."""
    from .waymo_raw import create_waymo_infos as _impl
    return _impl(*args, **kwargs)


def create_waymo_gt_database(dataset_cfg, class_names, data_path=None):
    """The gt database of the train split, every frame of it (the test
    split's SAMPLED_INTERVAL, 1, applies): pcdet_gt_database_train/ and
    pcdet_waymo_dbinfos_train.pkl under the data path, which the gt
    sampling of DATA_AUGMENTOR reads.  No augmentor is built: the
    database does not exist yet."""
    dataset = WaymoDataset(dataset_cfg, class_names, training=False,
                           root_path=data_path)
    dataset.split = dataset_cfg.DATA_SPLIT['train']
    split_file = dataset.root_path / 'ImageSets' / f'{dataset.split}.txt'
    dataset.sample_sequence_list = [
        x.strip() for x in open(split_file).readlines()]
    dataset.infos = []
    dataset.include_waymo_data()
    return dataset.create_groundtruth_database(used_classes=class_names)


if __name__ == '__main__':
    import sys

    from ..config import cfg_from_yaml_file
    if len(sys.argv) > 1 and sys.argv[1] == 'create_waymo_gt_database':
        cfg = cfg_from_yaml_file(sys.argv[2])
        db = create_waymo_gt_database(
            cfg.DATA_CONFIG, cfg.CLASS_NAMES,
            sys.argv[3] if len(sys.argv) > 3 else None)
        print({str(k): len(v) for k, v in db.items()})
