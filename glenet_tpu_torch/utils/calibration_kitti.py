"""KITTI calibration: P2 / R0 / Tr_velo_to_cam matrices and the
lidar <-> rect <-> image projections (host-side numpy; the port's own copy
of glenet_tpu/utils/calibration_kitti.py).

The rect frame is the rectified camera frame (x right, y down, z forward);
the lidar frame is velodyne (x forward, y left, z up).
"""
from __future__ import annotations

import numpy as np


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()
    obj = lines[2].strip().split(' ')[1:]
    P2 = np.array(obj, dtype=np.float32)
    obj = lines[3].strip().split(' ')[1:]
    P3 = np.array(obj, dtype=np.float32)
    obj = lines[4].strip().split(' ')[1:]
    R0 = np.array(obj, dtype=np.float32)
    obj = lines[5].strip().split(' ')[1:]
    Tr_velo_to_cam = np.array(obj, dtype=np.float32)
    return {'P2': P2.reshape(3, 4), 'P3': P3.reshape(3, 4),
            'R0': R0.reshape(3, 3), 'Tr_velo2cam': Tr_velo_to_cam.reshape(3, 4)}


class Calibration:
    def __init__(self, calib_file):
        calib = calib_file if isinstance(calib_file, dict) \
            else get_calib_from_file(calib_file)
        self.P2 = calib['P2']            # (3, 4)
        self.R0 = calib['R0']            # (3, 3)
        self.V2C = calib['Tr_velo2cam']  # (3, 4)

        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def cart_to_hom(pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def rect_to_lidar(self, pts_rect):
        """(N, 3) rect -> (N, 3) lidar."""
        pts_rect_hom = self.cart_to_hom(pts_rect)                # (N, 4)
        R0_ext = np.hstack((self.R0, np.zeros((3, 1), dtype=np.float32)))
        R0_ext = np.vstack((R0_ext, np.zeros((1, 4), dtype=np.float32)))
        R0_ext[3, 3] = 1
        V2C_ext = np.vstack((self.V2C, np.zeros((1, 4), dtype=np.float32)))
        V2C_ext[3, 3] = 1
        pts_lidar = pts_rect_hom @ np.linalg.inv((R0_ext @ V2C_ext).T)
        return pts_lidar[:, 0:3]

    def lidar_to_rect(self, pts_lidar):
        """(N, 3) lidar -> (N, 3) rect."""
        pts_lidar_hom = self.cart_to_hom(pts_lidar)
        pts_rect = pts_lidar_hom @ self.V2C.T @ self.R0.T
        return pts_rect

    def rect_to_img(self, pts_rect):
        """(N, 3) rect -> (N, 2) image uv + (N,) rect depth."""
        pts_rect_hom = self.cart_to_hom(pts_rect)
        pts_2d_hom = pts_rect_hom @ self.P2.T
        pts_img = (pts_2d_hom[:, 0:2].T / pts_rect_hom[:, 2]).T
        pts_rect_depth = pts_2d_hom[:, 2] - self.P2.T[3, 2]
        return pts_img, pts_rect_depth

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.concatenate(
            [x.reshape(-1, 1), y.reshape(-1, 1), depth_rect.reshape(-1, 1)],
            axis=1)


def dummy_calibration() -> Calibration:
    """Identity-ish calibration for synthetic-data tests: rect frame equals a
    permuted lidar frame (x_cam = -y_l, y_cam = -z_l, z_cam = x_l)."""
    V2C = np.array([[0, -1, 0, 0],
                    [0, 0, -1, 0],
                    [1, 0, 0, 0]], dtype=np.float32)
    return Calibration({
        'P2': np.array([[700, 0, 600, 0], [0, 700, 180, 0], [0, 0, 1, 0]],
                       np.float32),
        'P3': np.array([[700, 0, 600, 0], [0, 700, 180, 0], [0, 0, 1, 0]],
                       np.float32),
        'R0': np.eye(3, dtype=np.float32),
        'Tr_velo2cam': V2C,
    })


def get_road_plane(plane_file):
    """KITTI `planes/<id>.txt` -> (4,) road plane (a, b, c, d) in the rect
    frame, normal pointing up (b < 0), unit length."""
    with open(plane_file) as f:
        lines = f.readlines()
    plane = np.asarray([float(i) for i in lines[3].split()])
    if plane[1] > 0:
        plane = -plane
    return plane / np.linalg.norm(plane[0:3])


def put_boxes_on_road_planes(gt_boxes, road_plane, calib):
    """Move lidar boxes (N, 7+) down or up so their bottoms sit on the road
    plane; returns (moved boxes, the height each moved by)."""
    a, b, c, d = road_plane
    center_cam = calib.lidar_to_rect(gt_boxes[:, 0:3])
    cur_height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
    center_cam[:, 1] = cur_height_cam
    cur_lidar_height = calib.rect_to_lidar(center_cam)[:, 2]
    mv_height = gt_boxes[:, 2] - gt_boxes[:, 5] / 2 - cur_lidar_height
    gt_boxes = gt_boxes.copy()
    gt_boxes[:, 2] -= mv_height
    return gt_boxes, mv_height
