"""Anchor-based dense heads, their decode and their losses (torch
counterpart of glenet_tpu/models/anchor_heads.py):

  - AnchorHeadSingle: 1x1 cls / box / direction convs (also SE-SSD's
    AnchorHeadSessd, which differs only in its regression loss);
  - AnchorHeadKLLabel: AnchorHeadSingle plus a log-variance branch
    (GLENet-S), an IoU branch (with it GLENet-C's AnchorHeadKLLabelIoU;
    alone AnchorHeadIoU) and the variance-guided IoU gate
    (AnchorHeadKLLabelIoUGuide).

The losses: focal classification, direction-bin cross entropy, the
sin-difference smooth-L1, KL-label, KL and od-IoU regression losses, and
the IoU branch's smooth-L1 against 2 * IoU3D(pred, gt) - 1.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import iou3d
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


class AnchorHeadKLLabel(AnchorHeadSingle):
    """AnchorHeadSingle plus optional branches, as JAX's flags select them:
    `with_std_branch` (conv_box_std, the predicted log variance of each
    code), `with_iou_branch` (conv_iou, one IoU per class) and `with_guide`
    (std_conv1 / std_conv2: a sigmoid gate on the IoU computed from the
    log-variance map)."""

    def __init__(self, in_channels: int, num_class: int,
                 num_anchors_per_location: int, code_size: int = 7,
                 num_dir_bins: int = 0, with_iou_branch: bool = False,
                 with_std_branch: bool = True, with_guide: bool = False):
        super().__init__(in_channels, num_class, num_anchors_per_location,
                         code_size, num_dir_bins)
        a = num_anchors_per_location

        def conv(name, cin, cout, std):
            c = nn.Conv2d(cin, cout, 1)
            nn.init.normal_(c.weight, std=std)
            nn.init.zeros_(c.bias)
            setattr(self, name, c)

        self.with_std_branch = with_std_branch
        self.with_iou_branch = with_iou_branch
        self.with_guide = with_guide
        if with_std_branch:
            conv('conv_box_std', in_channels, a * code_size, 1e-4)
        if with_iou_branch:
            conv('conv_iou', in_channels, a * num_class, 1e-3)
            if with_guide:
                conv('std_conv1', a * code_size, 64, 1e-3)
                conv('std_conv2', 64, 1, 1e-3)

    def forward(self, x, train: bool = False):
        out = super().forward(x, train)
        x = x.permute(0, 3, 1, 2)
        b, _, h, w = x.shape

        def nhwc(t, c):
            return t.permute(0, 2, 3, 1).reshape(b, h, w, self.a, c)

        std_raw = None
        if self.with_std_branch:
            std_raw = self.conv_box_std(x)
            out['box_std_preds'] = nhwc(std_raw, self.code_size)
        if self.with_iou_branch:
            iou = self.conv_iou(x)
            if self.with_guide:
                gate = self.std_conv2(F.relu(self.std_conv1(std_raw)))
                iou = iou * torch.sigmoid(gate)
            out['iou_preds'] = nhwc(iou, self.num_class)
        return out


def build_dense_head(name, in_channels, num_class, num_anchors_per_location,
                     code_size, num_dir_bins):
    """The dense head of DENSE_HEAD.NAME, as JAX's DetectorNet.setup picks
    it; the names it does not port raise."""
    args = (in_channels, num_class, num_anchors_per_location, code_size,
            num_dir_bins)
    if name in ('AnchorHeadSingle', 'AnchorHeadSessd'):
        return AnchorHeadSingle(*args)
    flags = {'AnchorHeadKLLabel': {}, 'AnchorHeadKL': {},
             'AnchorHeadKLLabelIoU': {'with_iou_branch': True},
             'AnchorHeadKLLabelIoUGuide': {'with_iou_branch': True,
                                           'with_guide': True},
             'AnchorHeadIoU': {'with_iou_branch': True,
                               'with_std_branch': False}}
    if name not in flags:
        raise NotImplementedError(f'DENSE_HEAD {name} is not ported yet')
    return AnchorHeadKLLabel(*args, **flags[name])


def _flatten_preds(out):
    """(B, H, W, A, C) head outputs -> (B, N, C)."""
    return {k: v.reshape(v.shape[0], -1, v.shape[-1]) for k, v in out.items()}


def decode_predictions(out, flat_anchors, box_coder, dir_offset=0.78539,
                       dir_limit_offset=0.0, num_dir_bins=2):
    """Head outputs -> raw cls logits (B, N, num_class) and decoded boxes
    (B, N, 7), with the direction-bin heading correction, plus the raw log
    variances (B, N, 7) and IoU outputs (B, N, num_class) of the heads that
    have them."""
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
    result = {'batch_cls_preds': flat['cls_preds'], 'batch_box_preds': boxes}
    if 'box_std_preds' in flat:
        result['batch_box_std_preds'] = flat['box_std_preds']
    if 'iou_preds' in flat:
        result['batch_iou_preds'] = flat['iou_preds']
    return result


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


def _positive_weights(box_cls_labels):
    """(B, N) weights: 1 on positives over their count in the sample."""
    positives = box_cls_labels > 0
    return positives.to(torch.float32) / positives.sum(
        dim=1, keepdim=True).to(torch.float32).clamp_min(1.0)


def reg_loss_smooth_l1(box_preds, box_reg_targets, box_cls_labels,
                       code_weights=None):
    """Sin-difference smooth-L1 regression loss over positives, normalised
    per sample by their count, over the batch size."""
    batch_size = box_preds.shape[0]
    reg_weights = _positive_weights(box_cls_labels)
    preds_sin, targets_sin = losses.add_sin_difference(box_preds,
                                                       box_reg_targets)
    return losses.weighted_smooth_l1(preds_sin, targets_sin, reg_weights,
                                     code_weights=code_weights
                                     ).sum() / batch_size


def reg_loss_kl_label(box_preds, box_std_preds, box_reg_targets,
                      box_cls_labels, label_uncertainty, code_weights=None):
    """GLENet's KL-label regression loss over positives (weights normalised
    per sample), over the batch size -> (loss, {loc_loss_src,
    loc_loss_square, loc_loss_log} over the batch size)."""
    batch_size = box_preds.shape[0]
    total, parts = losses.kl_label_reg_loss(
        box_preds, box_std_preds, box_reg_targets,
        _positive_weights(box_cls_labels), label_uncertainty,
        code_weights=code_weights)
    return total / batch_size, {k: v / batch_size for k, v in parts.items()}


def reg_loss_kl(box_preds, box_std_preds, box_reg_targets, box_cls_labels,
                code_weights=None):
    """The predicted-variance KL loss without label variances (AnchorHeadKL):
    exp(-s) * smoothL1 + 0.5 * s * w, over the batch size."""
    batch_size = box_preds.shape[0]
    reg_weights = _positive_weights(box_cls_labels)
    preds_sin, targets_sin = losses.add_sin_difference(box_preds,
                                                       box_reg_targets)
    l1 = losses.weighted_smooth_l1(preds_sin, targets_sin, reg_weights,
                                   code_weights=code_weights)
    s = box_std_preds
    return (torch.exp(-s) * l1
            + 0.5 * s * reg_weights[..., None]).sum() / batch_size


def reg_loss_odiou(box_preds, box_reg_targets, box_cls_labels, flat_anchors,
                   box_coder):
    """SE-SSD's od-IoU regression loss on decoded boxes: every anchor's
    decoded prediction against its decoded target (which carries no
    gradient), weighted by the positives normalised per sample."""
    batch_size = box_preds.shape[0]
    reg_weights = _positive_weights(box_cls_labels)
    anchors = flat_anchors[None].expand(batch_size, *flat_anchors.shape)
    pred_boxes = box_coder.decode(box_preds, anchors).reshape(-1, 7)
    with torch.no_grad():
        gt_boxes = box_coder.decode(box_reg_targets, anchors).reshape(-1, 7)
    return losses.odiou_3d_loss(gt_boxes, pred_boxes,
                                reg_weights.reshape(-1), batch_size)


def iou_branch_loss(iou_preds, box_preds, box_reg_targets, box_cls_labels,
                    flat_anchors, box_coder):
    """The IoU branch's loss: smooth-L1 (beta 1/9) of iou_preds[..., 0]
    against 2 * IoU3D(decoded pred, decoded gt) - 1, which carries no
    gradient, over positives (weights normalised per sample), over the
    batch size."""
    batch_size = iou_preds.shape[0]
    reg_weights = _positive_weights(box_cls_labels)
    anchors = flat_anchors[None].expand(batch_size, *flat_anchors.shape)
    with torch.no_grad():
        pred_boxes = box_coder.decode(box_preds, anchors)[..., :7]
        gt_boxes = box_coder.decode(box_reg_targets, anchors)[..., :7]
        iou = iou3d.boxes_aligned_iou3d(pred_boxes.reshape(-1, 7),
                                        gt_boxes.reshape(-1, 7))
        iou_target = (2.0 * iou - 1.0).reshape(batch_size, -1, 1)
    return losses.weighted_smooth_l1(iou_preds[..., 0:1], iou_target,
                                     reg_weights).sum() / batch_size
