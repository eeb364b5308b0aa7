"""Pandaset adapter (the port's own copy of
glenet_tpu/datasets/pandaset_dataset.py).

Infos with lidar_path pointing at (N, 4) float32 .npy or .bin points in
the normative ego frame (pandaset_raw.create_pandaset_infos with
extract_frames writes them), gt_boxes and gt_names.  The points are padded
with zero columns to 5, as nuScenes' sweeps carry, and the evaluation is
KITTI's AP of the annos turned into KITTI's format (Car, Pedestrian and
Cyclist), its overlaps on the dataset's device.
"""
from __future__ import annotations

import numpy as np

from .nuscenes_dataset import NuScenesDataset

KITTI_CLASSES = ('Car', 'Pedestrian', 'Cyclist')


def to_kitti_names(names):
    """Pandaset names -> KITTI's: car / pedestrian / cyclist in any case to
    Car / Pedestrian / Cyclist, every other name title-cased."""
    return np.array([{'car': 'Car', 'pedestrian': 'Pedestrian',
                      'cyclist': 'Cyclist'}.get(str(n).lower(),
                                                str(n).title())
                     for n in names])


class PandasetDataset(NuScenesDataset):
    METRIC = 'KITTI'

    def get_lidar_with_sweeps(self, index):
        """A frame's points, padded to 5 columns."""
        info = self.infos[index]
        path = self.root_path / info['lidar_path']
        if path.suffix == '.npy':
            pts = np.load(str(path)).astype(np.float32)
        else:
            pts = np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)
        if pts.shape[1] < 5:
            pts = np.concatenate(
                [pts, np.zeros((len(pts), 5 - pts.shape[1]), np.float32)],
                axis=1)
        return pts

    def evaluation(self, det_annos, class_names, device=None):
        """KITTI's AP (eval/kitti_eval.py) of the lidar boxes in KITTI's
        format, over the KITTI classes among `class_names`; the overlaps run
        on `device` (the GPU by default)."""
        from ..eval import kitti_eval
        from .waymo_utils import transform_annos_to_kitti_format
        gt_annos = [transform_annos_to_kitti_format(
            {'name': to_kitti_names(info['gt_names']),
             'gt_boxes_lidar': np.asarray(info['gt_boxes'])[:, :7]})
            for info in self.infos]
        dt_annos = []
        for a in det_annos:
            a = dict(a)
            a['name'] = to_kitti_names(a['name'])
            dt_annos.append(transform_annos_to_kitti_format(a))
        kitti_classes = [c for c in (str(n).title() for n in class_names)
                         if c in KITTI_CLASSES]
        return kitti_eval.get_official_eval_result(
            gt_annos, dt_annos, kitti_classes, device=device)
