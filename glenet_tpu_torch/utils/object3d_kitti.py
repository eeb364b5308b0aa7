"""KITTI label_2 txt parser and difficulty levels (host-side; the port's
own copy of glenet_tpu/utils/object3d_kitti.py)."""
from __future__ import annotations

import numpy as np


def get_objects_from_label(label_file):
    with open(label_file) as f:
        lines = f.readlines()
    return [Object3d(line) for line in lines]


def cls_type_to_id(cls_type):
    type_to_id = {'Car': 1, 'Pedestrian': 2, 'Cyclist': 3, 'Van': 4}
    return type_to_id.get(cls_type, -1)


class Object3d:
    def __init__(self, line: str):
        label = line.strip().split(' ')
        self.src = line
        self.cls_type = label[0]
        self.cls_id = cls_type_to_id(self.cls_type)
        self.truncation = float(label[1])
        self.occlusion = float(label[2])  # 0..3 (3 = unknown)
        self.alpha = float(label[3])
        self.box2d = np.array(
            [float(label[4]), float(label[5]), float(label[6]), float(label[7])],
            dtype=np.float32)
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])
        self.loc = np.array(
            [float(label[11]), float(label[12]), float(label[13])],
            dtype=np.float32)
        self.dis_to_cam = np.linalg.norm(self.loc)
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0
        self.level_str = None
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self):
        height = float(self.box2d[3]) - float(self.box2d[1])
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = 'Easy'
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = 'Moderate'
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = 'Hard'
            return 2
        self.level_str = 'UnKnown'
        return -1

    def generate_corners3d(self):
        from . import box_utils
        boxes = np.array([[*self.loc, self.l, self.h, self.w, self.ry]],
                         np.float32)
        return box_utils.boxes3d_to_corners3d_kitti_camera(
            boxes, bottom_center=True)[0]
