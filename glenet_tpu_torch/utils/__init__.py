"""Geometry helpers and the weight bridge from glenet_tpu variables."""
