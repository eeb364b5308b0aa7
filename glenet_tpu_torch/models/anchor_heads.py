"""Anchor-based dense head AnchorHeadSingle and its decode (torch
counterpart of glenet_tpu/models/anchor_heads.py)."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..utils import common


class AnchorHeadSingle(nn.Module):
    """1x1 conv heads on BEV features.  Input (B, H, W, C) (a channels-last
    view); outputs (B, H, W, A, C_out) per branch."""

    def __init__(self, in_channels: int, num_class: int,
                 num_anchors_per_location: int, code_size: int = 7,
                 num_dir_bins: int = 0):
        super().__init__()
        a = num_anchors_per_location
        self.num_class, self.code_size, self.a = num_class, code_size, a
        self.conv_cls = nn.Conv2d(in_channels, a * num_class, 1)
        self.conv_box = nn.Conv2d(in_channels, a * code_size, 1)
        self.num_dir_bins = num_dir_bins
        if num_dir_bins > 0:
            self.conv_dir_cls = nn.Conv2d(in_channels, a * num_dir_bins, 1)
        # focal-style prior on the classification bias (pi = 0.01)
        nn.init.constant_(self.conv_cls.bias, -math.log((1 - 0.01) / 0.01))
        nn.init.normal_(self.conv_box.weight, std=0.001)
        nn.init.zeros_(self.conv_box.bias)

    def forward(self, x, train: bool = False):
        x = x.permute(0, 3, 1, 2)
        b, _, h, w = x.shape

        def head(conv, c):
            return conv(x).permute(0, 2, 3, 1).reshape(b, h, w, self.a, c)

        out = {'cls_preds': head(self.conv_cls, self.num_class),
               'box_preds': head(self.conv_box, self.code_size)}
        if self.num_dir_bins > 0:
            out['dir_cls_preds'] = head(self.conv_dir_cls, self.num_dir_bins)
        return out


def _flatten_preds(out):
    """(B, H, W, A, C) head outputs -> (B, N, C)."""
    return {k: v.reshape(v.shape[0], -1, v.shape[-1]) for k, v in out.items()}


def decode_predictions(out, flat_anchors, box_coder, dir_offset=0.78539,
                       dir_limit_offset=0.0, num_dir_bins=2):
    """Head outputs -> raw cls logits (B, N, num_class) and decoded boxes
    (B, N, 7), with the direction-bin heading correction."""
    flat = _flatten_preds(out)
    b = flat['cls_preds'].shape[0]
    anchors = flat_anchors[None].expand(b, *flat_anchors.shape)
    boxes = box_coder.decode(flat['box_preds'], anchors)
    if 'dir_cls_preds' in flat and num_dir_bins > 0:
        dir_labels = flat['dir_cls_preds'].argmax(dim=-1)
        period = 2 * math.pi / num_dir_bins
        dir_rot = common.limit_period(boxes[..., 6] - dir_offset,
                                      dir_limit_offset, period)
        heading = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
        boxes = torch.cat([boxes[..., :6], heading[..., None], boxes[..., 7:]],
                          dim=-1)
    return {'batch_cls_preds': flat['cls_preds'], 'batch_box_preds': boxes}
