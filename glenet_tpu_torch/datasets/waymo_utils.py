"""Waymo helpers (the port's own copy of glenet_tpu/datasets/waymo_utils.py):
lidar-frame annos -> KITTI-format annos, so the KITTI AP evaluator can score
Waymo predictions (semantics of the reference
pcdet/datasets/kitti/kitti_utils.py:5-50)."""
from __future__ import annotations

import numpy as np

_WAYMO_TO_KITTI = {'Vehicle': 'Car', 'Pedestrian': 'Pedestrian',
                   'Cyclist': 'Cyclist', 'Sign': 'Sign', 'Car': 'Car'}


def transform_annos_to_kitti_format(anno, map_name_to_kitti=False):
    """One anno dict with name + boxes_lidar / gt_boxes_lidar (+ score) ->
    KITTI-format camera-frame fields, with fake 50 px 2D boxes (no
    images)."""
    anno = dict(anno)
    names = np.asarray(anno['name']).copy()
    if map_name_to_kitti:
        names = np.array([_WAYMO_TO_KITTI.get(n, n) for n in names])
    anno['name'] = names

    n = len(names)
    anno['bbox'] = np.zeros((n, 4))
    anno['bbox'][:, 2:4] = 50
    anno['truncated'] = np.zeros(n)
    anno['occluded'] = np.zeros(n)
    if 'score' not in anno:
        anno['score'] = np.zeros(n)
    anno['alpha'] = np.full(n, -10.0)

    boxes = np.asarray(anno.get('boxes_lidar',
                                anno.get('gt_boxes_lidar',
                                         np.zeros((0, 7)))))[:, :7].copy()
    if len(boxes):
        boxes[:, 2] -= boxes[:, 5] / 2
        anno['location'] = np.stack(
            [-boxes[:, 1], -boxes[:, 2], boxes[:, 0]], axis=1)
        anno['dimensions'] = boxes[:, [3, 5, 4]]          # lwh -> lhw
        anno['rotation_y'] = -boxes[:, 6] - np.pi / 2.0
        anno['alpha'] = (-np.arctan2(-boxes[:, 1], boxes[:, 0])
                         + anno['rotation_y'])
    else:
        anno['location'] = np.zeros((0, 3))
        anno['dimensions'] = np.zeros((0, 3))
        anno['rotation_y'] = np.zeros(0)
        anno['alpha'] = np.zeros(0)
    return anno
