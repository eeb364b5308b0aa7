"""Anchor-to-gt target assignment of the GLENet-VR dense head (torch
counterpart of glenet_tpu/models/target_assigner.py, the axis-aligned
assigner without MATCH_HEIGHT, as every KITTI config sets it; ATSS is not
on the port's path).

Per class, over that class's anchor subset and gts:
  - IoU is the nearest-BEV IoU;
  - anchors with IoU >= matched_threshold are positive, matched to their
    argmax gt (the first on ties);
  - force-match: every gt with a nonzero best overlap makes its best
    anchor(s) positive even below the threshold, with the first matching
    gt as the forcing one;
  - anchors with IoU < unmatched_threshold are background (0), the rest
    ignored (-1);
  - box targets encode the argmax gt against the anchor;
  - label uncertainty: forced anchors carry the forcing gt's (7,) variance,
    positives the argmax gt's (positives win), background keeps 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import box_utils


class TargetDict(NamedTuple):
    box_cls_labels: torch.Tensor     # (num_anchors,) int32: -1 ignore, 0 bg
    box_reg_targets: torch.Tensor    # (num_anchors, code_size)
    reg_weights: torch.Tensor        # (num_anchors,) float 0 / 1
    label_uncertainty: torch.Tensor  # (num_anchors, 7)


def assign_targets_single_class(anchors, gt_boxes, gt_valid, gt_unc,
                                class_id, matched_thr, unmatched_thr,
                                box_coder):
    """anchors (Na, 7); gt_boxes (M, 7); gt_valid (M,) bool, True only for
    gts of this class; gt_unc (M, 7) -> labels (Na,) int32, box targets
    (Na, code_size), label uncertainty (Na, 7)."""
    na = anchors.shape[0]
    iou = box_utils.boxes3d_nearest_bev_iou(anchors, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, -1.0)               # (Na, M)

    anchor_to_gt_max, anchor_to_gt_argmax = iou.max(dim=1)
    gt_to_anchor_max = iou.amax(dim=0)                            # (M,)
    force_eligible = gt_valid & (gt_to_anchor_max > 0)
    force_mat = (iou == gt_to_anchor_max[None, :]) & force_eligible[None, :]
    anchor_forced = force_mat.any(dim=1)
    forced_gt = force_mat.to(torch.uint8).argmax(dim=1)           # first match

    positive = anchor_to_gt_max >= matched_thr
    background = anchor_to_gt_max < unmatched_thr
    labels = torch.full((na,), -1, dtype=torch.int32, device=anchors.device)
    labels = torch.where(background, 0, labels)
    labels = torch.where(anchor_forced | positive, class_id, labels)
    labels = labels.to(torch.int32)

    fg = positive | anchor_forced
    enc = box_coder.encode(gt_boxes[anchor_to_gt_argmax], anchors)
    box_targets = torch.where(fg[:, None], enc, 0.0)

    unc = torch.zeros((na, 7), dtype=gt_unc.dtype, device=anchors.device)
    unc = torch.where(anchor_forced[:, None], gt_unc[forced_gt], unc)
    unc = torch.where(positive[:, None], gt_unc[anchor_to_gt_argmax], unc)
    return labels, box_targets, unc


def assign_targets(anchor_set, gt_boxes_with_cls, gt_mask, gt_uncertainty,
                   box_coder):
    """Per-sample assignment over all classes.

    anchor_set: anchors.AnchorSet; gt_boxes_with_cls (M, 8), 7 box values
    and the 1-based class id; gt_mask (M,) bool; gt_uncertainty (M, 7).
    Returns a TargetDict over the flat (H * W * A) anchors.
    """
    h, w = anchor_set.feature_map_size
    dev = gt_boxes_with_cls.device
    gt_boxes = gt_boxes_with_cls[:, :7]
    gt_cls = gt_boxes_with_cls[:, 7].to(torch.int32)
    anchors_hw = torch.as_tensor(anchor_set.anchors, device=dev)  # (H,W,A,7)
    labels_c, targets_c, unc_c = [], [], []
    for ci, name in enumerate(anchor_set.class_names):
        sl = anchor_set.class_slices[ci]
        a_c = sl.stop - sl.start
        labels, box_t, unc = assign_targets_single_class(
            anchors_hw[:, :, sl].reshape(-1, 7), gt_boxes,
            gt_mask & (gt_cls == ci + 1), gt_uncertainty,
            class_id=ci + 1,
            matched_thr=anchor_set.matched_thresholds[name],
            unmatched_thr=anchor_set.unmatched_thresholds[name],
            box_coder=box_coder)
        labels_c.append(labels.reshape(h, w, a_c))
        targets_c.append(box_t.reshape(h, w, a_c, -1))
        unc_c.append(unc.reshape(h, w, a_c, 7))
    labels = torch.cat(labels_c, dim=2).reshape(-1)
    box_targets = torch.cat(targets_c, dim=2)
    return TargetDict(
        box_cls_labels=labels,
        box_reg_targets=box_targets.reshape(-1, box_targets.shape[-1]),
        reg_weights=(labels > 0).to(torch.float32),
        label_uncertainty=torch.cat(unc_c, dim=2).reshape(-1, 7))
