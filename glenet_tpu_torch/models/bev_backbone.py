"""Dense 2D BEV backbone (torch counterpart of
glenet_tpu/models/bev_backbone.py BaseBEVBackbone): multi-level strided conv
blocks + transpose-conv up-branches, concatenated."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import ConvBlock


class BaseBEVBackbone(nn.Module):
    """Children are named ConvBlock_<i> in creation order, as in the JAX
    module."""

    def __init__(self, in_channels: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[int] = (),
                 num_upsample_filters: Sequence[int] = ()):
        super().__init__()
        if any(s < 1 for s in upsample_strides):
            raise NotImplementedError('fractional upsample strides are not '
                                      'ported yet')
        self.levels = []
        n = 0

        def block(*args, **kwargs):
            nonlocal n
            name = f'ConvBlock_{n}'
            setattr(self, name, ConvBlock(*args, **kwargs))
            n += 1
            return name

        c = in_channels
        for i, n_layers in enumerate(layer_nums):
            names = [block(c, num_filters[i], 3, layer_strides[i], padding=1)]
            c = num_filters[i]
            names += [block(c, c, 3, 1, padding=1) for _ in range(n_layers)]
            up = None
            if upsample_strides:
                s = upsample_strides[i]
                # stride == kernel deconvolution (flax ConvTranspose 'SAME')
                up = block(c, num_upsample_filters[i], s, s, transpose=True)
            self.levels.append((names, up))
        self.num_bev_features = (sum(num_upsample_filters)
                                 if num_upsample_filters else num_filters[-1])

    def forward(self, x, train: bool = False):
        """x: (B, H, W, C) (a channels-last view) -> (B, H', W', C_out) view;
        the convolutions run on NCHW."""
        x = x.permute(0, 3, 1, 2)
        ups = []
        for names, up in self.levels:
            for name in names:
                x = getattr(self, name)(x, train)
            ups.append(getattr(self, up)(x, train) if up else x)
        out = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        return out.permute(0, 2, 3, 1)
