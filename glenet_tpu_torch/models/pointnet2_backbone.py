"""PointNet++ building blocks (torch counterpart of
glenet_tpu/models/pointnet2_backbone.py): the shared MLP that PV-RCNN's
set abstraction applies to every grouped neighbour.  The set-abstraction
levels of PointNet2MSG come with PointRCNN."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import MaskedBatchNorm


class SharedMLP(nn.Module):
    """Per layer a Linear without bias, MaskedBatchNorm (the default eps)
    and ReLU over the last axis; moments over every other axis (the
    grouped neighbours of every query of the batch)."""

    def __init__(self, in_channels: int, channels):
        super().__init__()
        self.depth = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f'mlp_{i}', nn.Linear(in_channels, c, bias=False))
            setattr(self, f'bn_{i}', MaskedBatchNorm(c))
            in_channels = c

    def forward(self, x, mask=None, train: bool = False):
        for i in range(self.depth):
            x = getattr(self, f'bn_{i}')(getattr(self, f'mlp_{i}')(x),
                                         mask=mask,
                                         use_running_average=not train)
            x = F.relu(x)
        return x
