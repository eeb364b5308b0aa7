"""Dense 2D BEV backbones (torch counterparts of
glenet_tpu/models/bev_backbone.py):

  - BaseBEVBackbone: multi-level strided conv blocks + transpose-conv
    up-branches, concatenated;
  - SSFA: CIA-SSD's spatial-semantic feature aggregation with softmax
    attention fusion, 128 channels at the input's resolution (GLENet-C).
"""
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


class SSFA(nn.Module):
    """A spatial branch at full resolution (3 convs, 128 channels) and a
    semantic branch at stride 2 (3 convs, 256); after 1x1 trans blocks the
    semantic branch is deconvolved back twice (k3 s2 p1 op1): deconv_0
    adds trans_0's output, deconv_1 stands alone.  conv_0 and conv_1 follow,
    and their outputs are blended by the softmax over the 1-channel w_0 /
    w_1 blocks (conv + BN, no ReLU).  Children carry JAX's names."""

    num_bev_features = 128

    def __init__(self, in_channels: int):
        super().__init__()
        blocks = [('bottom_up_0_0', in_channels, 128, 3, 1),
                  ('bottom_up_0_1', 128, 128, 3, 1),
                  ('bottom_up_0_2', 128, 128, 3, 1),
                  ('bottom_up_1_0', 128, 256, 3, 2),
                  ('bottom_up_1_1', 256, 256, 3, 1),
                  ('bottom_up_1_2', 256, 256, 3, 1),
                  ('trans_0', 128, 128, 1, 1), ('trans_1', 256, 256, 1, 1),
                  ('conv_0', 128, 128, 3, 1), ('conv_1', 128, 128, 3, 1)]
        for name, cin, cout, k, s in blocks:
            setattr(self, name, ConvBlock(cin, cout, k, s, padding=k // 2))
        for name in ('deconv_0', 'deconv_1'):
            setattr(self, name, ConvBlock(256, 128, 3, 2, padding=1,
                                          transpose=True, output_padding=1))
        for name in ('w_0', 'w_1'):
            setattr(self, name, ConvBlock(128, 1, 1, 1, use_relu=False))

    def forward(self, x, train: bool = False):
        """x: (B, H, W, C) (a channels-last view) -> (B, H, W, 128) view;
        H and W even."""
        x0 = x.permute(0, 3, 1, 2)
        for i in range(3):
            x0 = getattr(self, f'bottom_up_0_{i}')(x0, train)
        x1 = x0
        for i in range(3):
            x1 = getattr(self, f'bottom_up_1_{i}')(x1, train)
        x0t = self.trans_0(x0, train)
        x1t = self.trans_1(x1, train)
        o0 = self.conv_0(self.deconv_0(x1t, train) + x0t, train)
        o1 = self.conv_1(self.deconv_1(x1t, train), train)
        w = torch.softmax(torch.cat([self.w_0(o0, train),
                                     self.w_1(o1, train)], dim=1), dim=1)
        return (o0 * w[:, 0:1] + o1 * w[:, 1:2]).permute(0, 2, 3, 1)
