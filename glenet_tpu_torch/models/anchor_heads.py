"""Anchor-based dense head AnchorHeadSingle, its decode and its losses
(torch counterpart of glenet_tpu/models/anchor_heads.py)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import common, losses


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


def cls_loss(cls_preds, box_cls_labels, num_class):
    """Focal classification loss, summed over anchors and classes over the
    batch size (before cls_weight).  cls_preds (B, N, num_class);
    box_cls_labels (B, N) int: -1 ignored, 0 background."""
    batch_size = cls_preds.shape[0]
    positives = box_cls_labels > 0
    cls_weights = ((box_cls_labels == 0) | positives).to(torch.float32)
    cls_weights = cls_weights / positives.sum(dim=1, keepdim=True).clamp_min(1)
    labels = torch.where(box_cls_labels >= 0, box_cls_labels, 0)
    if num_class == 1:
        labels = torch.where(positives, 1, labels)
    one_hot = F.one_hot(labels.long(), num_class + 1)[..., 1:].to(
        cls_preds.dtype)
    return losses.sigmoid_focal_loss(cls_preds, one_hot,
                                     cls_weights).sum() / batch_size


def get_direction_targets(anchors, box_reg_targets, dir_offset, num_bins):
    """(B, N) int64 direction-bin targets of the gt headings."""
    rot_gt = box_reg_targets[..., 6] + anchors[..., 6]
    offset_rot = common.limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
    dir_cls = torch.floor(offset_rot / (2 * math.pi / num_bins)).long()
    return dir_cls.clamp(0, num_bins - 1)


def dir_loss(dir_cls_preds, dir_targets, positives, num_bins):
    """Direction-bin cross entropy over positives, normalised per sample by
    their count, over the batch size."""
    batch_size = dir_cls_preds.shape[0]
    weights = positives.to(torch.float32)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1.0)
    one_hot = F.one_hot(dir_targets, num_bins).to(dir_cls_preds.dtype)
    return losses.weighted_cross_entropy(dir_cls_preds, one_hot,
                                         weights).sum() / batch_size


def reg_loss_smooth_l1(box_preds, box_reg_targets, box_cls_labels,
                       code_weights=None):
    """Sin-difference smooth-L1 regression loss over positives, normalised
    per sample by their count, over the batch size."""
    batch_size = box_preds.shape[0]
    positives = box_cls_labels > 0
    reg_weights = positives.to(torch.float32)
    reg_weights = reg_weights / positives.sum(
        dim=1, keepdim=True).to(torch.float32).clamp_min(1.0)
    preds_sin, targets_sin = losses.add_sin_difference(box_preds,
                                                       box_reg_targets)
    return losses.weighted_smooth_l1(preds_sin, targets_sin, reg_weights,
                                     code_weights=code_weights
                                     ).sum() / batch_size
