"""Detector modules (nn.Module) of the GLENet-VR predict path."""
