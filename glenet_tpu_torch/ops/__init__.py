"""Voxelization, sparse-conv tables, IoU, NMS and the CUDA merge kernel."""
