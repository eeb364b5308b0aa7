"""PyTorch / CUDA port of glenet_tpu for NVIDIA Hopper (H100).

Mirrors glenet_tpu's module paths and names.  Imports torch, never JAX and
nothing of glenet_tpu.  Entry point: `models.detectors.build_detector`, which
puts the model on the GPU unless the caller asks for the CPU.
"""
