"""Evaluation metrics of the port: KITTI AP and Waymo AP / APH."""
