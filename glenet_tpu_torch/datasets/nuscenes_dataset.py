"""nuScenes adapter and its metric (the port's own copy of
glenet_tpu/datasets/nuscenes_dataset.py, host-side numpy).

Info pickles in the reference's schema (nuscenes_raw.py writes them):
lidar_path, sweeps (transform_matrix and time_lag), gt_boxes (N, 7 or 9
with velocity), gt_names, num_lidar_pts, token.

  - `get_lidar_with_sweeps`: the key frame's (N, 4) points and
    MAX_SWEEPS - 1 sweeps drawn without replacement from the info's list
    by the dataset's RandomState (the JAX package's call, so both packages
    take the same sweeps), each without its points within 1 m of the
    sensor in x and y, moved into the key frame by its transform_matrix,
    with a fifth column of its time lag;
  - `__getitem__`: the gt boxes with at least FILTER_MIN_POINTS_IN_GT lidar
    points (their velocity columns dropped), then WaymoDataset's
    augmentation, class filter, range mask, shuffle and padding;
  - `evaluation`: glenet_tpu's numpy version of the devkit's detection
    metric: greedy matching by BEV centre distance at 0.5 / 1 / 2 / 4 m,
    AP over the 101-point recall grid above 10% recall and precision,
    the TP errors ATE, ASE and AOE at 2 m, and NDS over mAP and those three
    (no velocity or attribute error: the models predict neither).
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .augmentor import DataAugmentor
from .waymo_dataset import WaymoDataset

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1


class NuScenesDataset(WaymoDataset):
    """WaymoDataset's item preparation, collation and prediction dicts;
    its own loading and evaluation."""

    METRIC = 'nuScenes'

    def __init__(self, dataset_cfg, class_names, training=True,
                 root_path=None, logger=None, seed=None):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.logger = logger
        self.root_path = Path(root_path if root_path is not None
                              else dataset_cfg.DATA_PATH)
        self.split = dataset_cfg.DATA_SPLIT['train' if training else 'test']
        self.max_sweeps = int(dataset_cfg.get('MAX_SWEEPS', 1))

        self.infos = []
        for name in dataset_cfg.get('INFO_PATH', {}).get(
                'train' if training else 'test',
                [f'nuscenes_infos_{self.split}.pkl']):
            p = self.root_path / name
            if p.exists():
                with open(p, 'rb') as f:
                    self.infos.extend(pickle.load(f))
        if self.logger:
            self.logger.info(
                f'{type(self).__name__} {self.split}: {len(self.infos)} '
                f'frames')

        self.pc_range = np.asarray(dataset_cfg.POINT_CLOUD_RANGE, np.float32)
        self.max_points = int(dataset_cfg.get('MAX_POINTS_PER_SCENE', 300000))
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

    def get_lidar_with_sweeps(self, index):
        """(N, 5) [x, y, z, intensity, time_lag]: the key frame and its
        drawn sweeps in the key frame's coordinates."""
        info = self.infos[index]
        pts = np.fromfile(str(self.root_path / info['lidar_path']),
                          dtype=np.float32).reshape(-1, 5)[:, :4]
        sweeps = [pts]
        times = [np.zeros((pts.shape[0], 1), np.float32)]
        n_extra = min(self.max_sweeps - 1, len(info.get('sweeps', [])))
        if n_extra > 0:
            for k in self.rng.choice(len(info['sweeps']), n_extra,
                                     replace=False):
                sw = info['sweeps'][k]
                p = np.fromfile(str(self.root_path / sw['lidar_path']),
                                dtype=np.float32).reshape(-1, 5)[:, :4]
                keep = ~((np.abs(p[:, 0]) < 1.0) & (np.abs(p[:, 1]) < 1.0))
                p = p[keep]
                if sw.get('transform_matrix') is not None:
                    hom = np.hstack([p[:, :3], np.ones((len(p), 1))])
                    p = p.copy()
                    p[:, :3] = (np.asarray(sw['transform_matrix'])
                                @ hom.T)[:3].T
                sweeps.append(p)
                times.append(np.full((p.shape[0], 1), sw['time_lag'],
                                     np.float32))
        pts = np.concatenate(sweeps)
        return np.concatenate([pts, np.concatenate(times)], axis=1)

    def __getitem__(self, index):
        info = self.infos[index]
        points = self.get_lidar_with_sweeps(index)
        data_dict = {'points': points,
                     'frame_id': Path(info['lidar_path']).stem}
        if 'gt_boxes' in info:
            min_pts = int(self.dataset_cfg.get('FILTER_MIN_POINTS_IN_GT', 0))
            mask = np.ones(len(info['gt_names']), bool)
            if min_pts and 'num_lidar_pts' in info:
                mask = np.asarray(info['num_lidar_pts']) >= min_pts
            gt = np.asarray(info['gt_boxes'])[mask]
            data_dict.update({
                'gt_boxes': gt[:, :7].astype(np.float32),
                'gt_names': np.asarray(info['gt_names'])[mask],
                'gt_uncertainty': -np.ones((int(mask.sum()), 7), np.float32),
                'gt_boxes_mask': np.ones(int(mask.sum()), bool),
            })
        return self.prepare_data(data_dict)

    def gt_annos(self):
        """Each info's gt names and boxes, as the evaluations take them."""
        return [{'name': np.asarray(info['gt_names']),
                 'boxes_lidar': np.asarray(info['gt_boxes'])}
                for info in self.infos]

    def evaluation(self, det_annos, class_names, device=None):
        """The nuScenes metric (nuscenes_evaluation), in numpy on the
        host."""
        return nuscenes_evaluation(det_annos, self.gt_annos(), class_names)


def _aligned_iou3d(a, b):
    """IoU of two boxes moved to one centre with one heading (the devkit's
    scale_iou): their sizes alone."""
    inter = np.prod(np.minimum(a[3:6], b[3:6]))
    union = np.prod(a[3:6]) + np.prod(b[3:6]) - inter
    return inter / max(union, 1e-9)


def _class_boxes(anno, cls):
    """The (K, 7) boxes of `anno` named `cls` and their mask."""
    mask = np.asarray([n == cls for n in anno['name']], bool)
    boxes = np.asarray(anno['boxes_lidar'])
    boxes = boxes.reshape(-1, boxes.shape[-1] if len(boxes) else 7)
    return boxes[mask][:, :7], mask


def _eval_class(det_annos, gt_annos, cls, dist_th):
    """One class's greedy matching at one centre-distance threshold, the
    detections of each frame in descending score order.  Returns (scores,
    is_tp, TP errors (ATE, ASE, AOE) of the matches, n_gt)."""
    scores, is_tp, errs = [], [], []
    n_gt = 0
    for det, gt in zip(det_annos, gt_annos):
        gboxes, _ = _class_boxes(gt, cls)
        n_gt += len(gboxes)
        dboxes, dmask = _class_boxes(det, cls)
        dscores = np.asarray(det['score'])[dmask]

        taken = np.zeros(len(gboxes), bool)
        for d in np.argsort(-dscores):
            if len(gboxes):
                dist = np.linalg.norm(
                    gboxes[:, :2] - dboxes[d, :2], axis=1)
                dist = np.where(taken, np.inf, dist)
                g = int(np.argmin(dist))
                hit = dist[g] < dist_th
            else:
                hit = False
            scores.append(dscores[d])
            is_tp.append(bool(hit))
            if hit:
                taken[g] = True
                dh = np.abs((dboxes[d, 6] - gboxes[g, 6] + np.pi)
                            % (2 * np.pi) - np.pi)
                errs.append((float(np.linalg.norm(
                    gboxes[g, :2] - dboxes[d, :2])),
                    1.0 - _aligned_iou3d(dboxes[d], gboxes[g]),
                    float(dh)))
    return (np.asarray(scores), np.asarray(is_tp, bool), errs, n_gt)


def _devkit_ap(scores, is_tp, n_gt):
    """The devkit's AP: precision interpolated on a 101-point recall grid,
    less MIN_PRECISION and clipped at 0, averaged over the grid points
    above MIN_RECALL and normalised by 1 - MIN_PRECISION."""
    if n_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = np.cumsum(is_tp[order])
    fp = np.cumsum(~is_tp[order])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    r_grid = np.linspace(0, 1, 101)
    p_interp = np.interp(r_grid, recall, precision, right=0)
    p_clipped = np.clip(p_interp - MIN_PRECISION, 0, None)
    above = r_grid > MIN_RECALL
    return float(p_clipped[above].mean() / (1 - MIN_PRECISION))


def nuscenes_evaluation(det_annos, gt_annos, class_names):
    """(result text, dict): per class the AP at each distance threshold and
    their mean (in %), mAP, mATE / mASE / mAOE over the classes with a
    match at 2 m (1 where none has one), and NDS = 100 (4 mAP + sum of
    1 - min(1, err / norm)) / 7, AOE normalised by pi."""
    ret = {}
    ap_all = []
    tp_errs = {'ATE': [], 'ASE': [], 'AOE': []}
    for cls in class_names:
        cls_aps = []
        for th in DIST_THRESHOLDS:
            scores, is_tp, errs, n_gt = _eval_class(
                det_annos, gt_annos, cls, th)
            ap = _devkit_ap(scores, is_tp, n_gt)
            cls_aps.append(ap)
            ret[f'{cls}_AP_{th}'] = ap * 100
            if th == TP_THRESHOLD and errs:
                e = np.asarray(errs)
                tp_errs['ATE'].append(e[:, 0].mean())
                tp_errs['ASE'].append(e[:, 1].mean())
                tp_errs['AOE'].append(e[:, 2].mean())
        ret[f'{cls}_AP'] = float(np.mean(cls_aps)) * 100
        ap_all.append(np.mean(cls_aps))

    mAP = float(np.mean(ap_all)) if ap_all else 0.0
    ret['mAP'] = mAP * 100
    tp_scores = []
    for k, norm in (('ATE', 1.0), ('ASE', 1.0), ('AOE', np.pi)):
        err = float(np.mean(tp_errs[k])) if tp_errs[k] else 1.0
        ret[f'm{k}'] = err
        tp_scores.append(max(0.0, 1.0 - min(1.0, err / norm)))
    ret['NDS'] = 100 * (4 * mAP + sum(tp_scores)) / (4 + len(tp_scores))
    lines = [f'{k}: {v:.4f}' for k, v in sorted(ret.items())]
    return '\n'.join(lines), ret
