"""Point heads (torch counterpart of glenet_tpu/models/point_heads.py):
PointRCNN's PointHeadBox on PointNet2MSG's per-point features, PartA2's
PointIntraPartOffsetHead on UNetV2's voxel-point features (foreground
segmentation and intra-object part locations, with the anchor-free box
branch of PartA2-free), their targets and losses: the point box targets
and loss (point_head_template semantics) serve PointHeadBox and
PartA2-free's box branch."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import distributed as dp

from ..utils import box_utils, common, losses
from .layers import MaskedBatchNorm


def _fc_stack(module, x, name, depth, mask, train):
    for i in range(depth):
        x = F.relu(getattr(module, f'{name}_bn{i}')(
            getattr(module, f'{name}_{i}')(x), mask=mask,
            use_running_average=not train))
    return x


class PointHeadBox(nn.Module):
    """PointRCNN's stage 1 (point_head_box.py): per-point class logits
    (num_class) after CLS_FC and box encodings (the point coder's
    code_size) after REG_FC, each layer a Linear without bias, BN over the
    valid points of the batch and ReLU."""

    def __init__(self, in_channels: int, num_class: int, code_size: int = 8,
                 cls_fc=(256, 256), reg_fc=(256, 256)):
        super().__init__()
        self.depth = {}
        for name, sizes in (('cls', cls_fc), ('reg', reg_fc)):
            c = in_channels
            for i, s in enumerate(sizes):
                setattr(self, f'{name}_{i}', nn.Linear(c, s, bias=False))
                setattr(self, f'{name}_bn{i}', MaskedBatchNorm(s))
                c = s
            self.depth[name] = (len(sizes), c)
        self.cls_out = nn.Linear(self.depth['cls'][1], num_class)
        self.box_out = nn.Linear(self.depth['reg'][1], code_size)
        nn.init.normal_(self.box_out.weight, std=0.001)

    def forward(self, point_features, mask, train: bool = False):
        """point_features (B, N, C), mask (B, N) -> point_cls_preds (B, N,
        num_class), point_box_preds (B, N, code_size)."""
        h_cls = _fc_stack(self, point_features, 'cls', self.depth['cls'][0],
                          mask, train)
        h_reg = _fc_stack(self, point_features, 'reg', self.depth['reg'][0],
                          mask, train)
        return {'point_cls_preds': self.cls_out(h_cls),
                'point_box_preds': self.box_out(h_reg)}


class PointIntraPartOffsetHead(nn.Module):
    """Per-point segmentation logits (num_class) and part offsets (3), each
    after its CLS_FC / PART_FC stack (Linear without bias, BN over the valid
    points, ReLU); with code_size > 0 also box encodings after REG_FC
    (PartA2-free's box branch, point_intra_part_head.py:31-37)."""

    def __init__(self, in_channels: int, num_class: int = 1, cls_fc=(),
                 part_fc=(), reg_fc=(), code_size: int = 0):
        super().__init__()
        self.stacks = {}
        for name, sizes in (('cls', cls_fc), ('part', part_fc),
                            ('reg', reg_fc if code_size > 0 else ())):
            c = in_channels
            for i, s in enumerate(sizes):
                setattr(self, f'{name}_{i}', nn.Linear(c, s, bias=False))
                setattr(self, f'{name}_bn{i}', MaskedBatchNorm(s))
                c = s
            self.stacks[name] = (len(sizes), c)
        self.cls_out = nn.Linear(self.stacks['cls'][1], num_class)
        self.part_out = nn.Linear(self.stacks['part'][1], 3)
        self.code_size = code_size
        if code_size > 0:
            self.box_out = nn.Linear(self.stacks['reg'][1], code_size)
            nn.init.normal_(self.box_out.weight, std=0.001)

    def _stack(self, x, name, mask, train):
        return _fc_stack(self, x, name, self.stacks[name][0], mask, train)

    def forward(self, point_features, mask, train: bool = False):
        """point_features (B, V, C), mask (B, V) -> point_cls_preds,
        point_part_preds and, with the box branch, point_box_preds."""
        out = {'point_cls_preds': self.cls_out(
                   self._stack(point_features, 'cls', mask, train)),
               'point_part_preds': self.part_out(
                   self._stack(point_features, 'part', mask, train))}
        if self.code_size > 0:
            out['point_box_preds'] = self.box_out(
                self._stack(point_features, 'reg', mask, train))
        return out


def box_membership(points_xyz, points_mask, gt_boxes, gt_mask, extra_width):
    """(first gt box holding each point, is_fg, is_ignore): foreground
    inside a gt box, ignored in its shell enlarged by extra_width."""
    boxes = gt_boxes[..., :7]
    inside = box_utils.points_in_boxes(points_xyz, boxes) & gt_mask[..., None,
                                                                    :]
    grow = torch.zeros(7, dtype=boxes.dtype, device=boxes.device)
    grow[3:6] = torch.tensor(extra_width, dtype=boxes.dtype)
    inside_big = (box_utils.points_in_boxes(points_xyz, boxes + grow)
                  & gt_mask[..., None, :])
    box_idx = inside.long().argmax(dim=-1)
    is_fg = inside.any(dim=-1) & points_mask
    is_ignore = inside_big.any(dim=-1) & ~is_fg & points_mask
    return box_idx, is_fg, is_ignore


def _gt_of_points(gt_boxes, box_idx):
    return torch.gather(gt_boxes, -2, box_idx[..., None].expand(
        *box_idx.shape, gt_boxes.shape[-1]))


def assign_part_targets(points_xyz, points_mask, gt_boxes, gt_mask,
                        extra_width=(0.2, 0.2, 0.2)):
    """Class-agnostic segmentation labels (1 fg, -1 ignored, 0 bg) and
    intra-part location targets in [0, 1]^3 (rotate(point - centre,
    -heading) / dims + 0.5, point_head_template.py:114-122).  points_xyz
    (B, N, 3), points_mask (B, N), gt_boxes (B, M, 8), gt_mask (B, M) ->
    seg (B, N) int64, part (B, N, 3), is_fg (B, N)."""
    box_idx, is_fg, is_ignore = box_membership(
        points_xyz, points_mask, gt_boxes, gt_mask, extra_width)
    seg = torch.where(is_ignore, -1, is_fg.long())
    gt_of = _gt_of_points(gt_boxes, box_idx)                  # (B, N, 8)
    rel = (points_xyz[..., :3] - gt_of[..., 0:3]).reshape(-1, 1, 3)
    local = common.rotate_points_along_z(
        rel, -gt_of[..., 6].reshape(-1)).reshape(points_xyz.shape[:-1] + (3,))
    part = (local / gt_of[..., 3:6] + 0.5).clamp(0.0, 1.0)
    part = torch.where(is_fg[..., None], part, 0.0)
    return seg, part, is_fg


def focal_cls_loss(cls_preds, labels, num_class, weight=1.0):
    """Sigmoid focal loss over (N, num_class) logits, labels (N,) with -1
    ignored, normalised by max(#positives, 1), times `weight`."""
    cared = labels >= 0
    pos = labels > 0
    one_hot = F.one_hot(labels.clamp_min(0), num_class + 1)[:, 1:]
    w = cared.float() / dp.global_count(pos.sum()).float().clamp_min(1.0)
    return losses.sigmoid_focal_loss(
        cls_preds[None], one_hot.to(cls_preds.dtype)[None], w[None]).sum() \
        * weight


def part_bce_loss(part_preds, part_labels, fg_mask):
    """BCE of the sigmoid part offsets (N, 3) against their targets, mean
    over the 3 axes, averaged over the foreground points."""
    prob = torch.sigmoid(part_preds)
    bce = -(part_labels * torch.log(prob.clamp_min(1e-7))
            + (1 - part_labels) * torch.log((1 - prob).clamp_min(1e-7)))
    fg = fg_mask.float()
    return (bce.mean(dim=-1) * fg).sum() / dp.global_count(
        fg.sum()).clamp_min(1.0)


def intra_part_loss(out, seg_labels, part_labels, fg_mask, loss_weights):
    """Focal segmentation loss and part BCE over the foreground
    (point_head_template.py:131-168).  out: point_cls_preds (N, C),
    point_part_preds (N, 3); labels flattened over the batch."""
    cls_preds = out['point_cls_preds']
    cls_loss = focal_cls_loss(cls_preds, seg_labels, cls_preds.shape[-1],
                               loss_weights.get('point_cls_weight', 1.0))
    part_loss = part_bce_loss(out['point_part_preds'], part_labels, fg_mask)
    return cls_loss, part_loss * loss_weights.get('point_part_weight', 1.0)


def assign_point_targets(points_xyz, points_mask, gt_boxes, gt_mask,
                         box_coder, extra_width=(0.2, 0.2, 0.2)):
    """Point targets (point_head_template.py assign_stack_targets): class
    labels (B, N) int64 (-1 ignored, 0 bg, else the gt class), box targets
    (B, N, code) encoded by the point coder against the points, fg mask
    (B, N)."""
    box_idx, is_fg, is_ignore = box_membership(
        points_xyz, points_mask, gt_boxes, gt_mask, extra_width)
    gt_of = _gt_of_points(gt_boxes, box_idx)
    gt_cls = gt_of[..., 7].long()
    cls = torch.where(is_fg, gt_cls, 0)
    cls = torch.where(is_ignore, -1, cls)
    targets = box_coder.encode(gt_of[..., :7], points_xyz, gt_cls)
    targets = torch.where(is_fg[..., None], targets, 0.0)
    return cls, targets, is_fg


def point_head_loss(out, cls_labels, box_targets, fg_mask, num_class,
                    loss_weights):
    """Focal classification and smooth-L1 box loss over the flattened
    points (point_head_template losses): out point_cls_preds (N, C),
    point_box_preds (N, code)."""
    cls_loss = focal_cls_loss(out['point_cls_preds'], cls_labels, num_class,
                               loss_weights.get('point_cls_weight', 1.0))
    n_pos = dp.global_count((cls_labels > 0).sum()).float().clamp_min(1.0)
    reg = losses.weighted_smooth_l1(out['point_box_preds'][None],
                                    box_targets[None],
                                    fg_mask.float()[None] / n_pos)
    return cls_loss, reg.sum() * loss_weights.get('point_box_weight', 1.0)
