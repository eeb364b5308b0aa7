"""Anchor-to-gt target assignment of the dense heads (torch counterpart of
glenet_tpu/models/target_assigner.py): the axis-aligned assigner and ATSS.

Axis-aligned, per class, over that class's anchor subset and gts:
  - IoU is the nearest-BEV IoU, or with MATCH_HEIGHT the 3D IoU;
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

ATSS (atss_assign_targets), over all anchors: each gt's TOPK anchors
nearest its centre are candidates, positive above the mean + std of their
IoUs whose centre lies in the gt's BEV rectangle; each anchor takes its
highest-IoU positive gt, and every gt's best anchor is force-matched.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import iou3d
from ..utils import box_utils, common, trace


class TargetDict(NamedTuple):
    box_cls_labels: torch.Tensor     # (num_anchors,) int32: -1 ignore, 0 bg
    box_reg_targets: torch.Tensor    # (num_anchors, code_size)
    reg_weights: torch.Tensor        # (num_anchors,) float 0 / 1
    label_uncertainty: torch.Tensor  # (num_anchors, 7)


def assign_targets_single_class(anchors, gt_boxes, gt_valid, gt_unc,
                                class_id, matched_thr, unmatched_thr,
                                box_coder, match_height=False):
    """anchors (Na, 7); gt_boxes (M, 7); gt_valid (M,) bool, True only for
    gts of this class; gt_unc (M, 7) -> labels (Na,) int32, box targets
    (Na, code_size), label uncertainty (Na, 7)."""
    na = anchors.shape[0]
    if match_height:
        iou = iou3d.boxes_iou3d(anchors, gt_boxes)
    else:
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
                   box_coder, match_height=False):
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
    trace.count('host_waits')           # the anchors copied to the card
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
            box_coder=box_coder, match_height=match_height)
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


def atss_assign_targets(anchor_set, gt_boxes_with_cls, gt_mask,
                        gt_uncertainty, box_coder, topk: int = 9,
                        match_height: bool = False):
    """ATSS adaptive assignment over the flat anchors of `anchor_set`, the
    arguments as assign_targets'.

    Per gt, its `topk` anchors nearest its centre (3D distance; of equal
    distances the lower anchor index first, as lax.top_k orders them) are
    candidates; the threshold is the mean of their IoUs plus the standard
    deviation with k - 1 in the denominator, plus 1e-6; positives are
    candidates at or above it whose centre lies in the gt's BEV rectangle
    (the reference's lw order).  Each anchor takes its highest-IoU
    positive gt (the first on ties); then every valid gt's best anchor (the
    first on ties) is force-matched to it, in gt order, so a later gt wins
    an anchor two gts share.  Positives carry their gt's label variance,
    the rest 1.  Returns a TargetDict."""
    big = 1e9
    dev = gt_boxes_with_cls.device
    anchors = torch.as_tensor(anchor_set.flat_anchors, dtype=torch.float32,
                              device=dev)                      # (N, 7)
    trace.count('host_waits')           # the anchors copied to the card
    n = anchors.shape[0]
    gt_boxes = gt_boxes_with_cls[:, :7]
    gt_cls = gt_boxes_with_cls[:, 7].to(torch.int32)
    m = gt_boxes.shape[0]
    if match_height:
        iou = iou3d.boxes_iou3d(anchors, gt_boxes)              # (N, M)
    else:
        iou = iou3d.boxes_iou_bev_blocked(anchors, gt_boxes)
    iou = torch.where(gt_mask[None, :], iou, 0.0)

    diff = anchors[None, :, 0:3] - gt_boxes[:, None, 0:3]       # (M, N, 3)
    dist = torch.sqrt((diff * diff).sum(dim=-1))
    k = min(topk, n)
    topk_idxs = torch.sort(dist, dim=1, stable=True).indices[:, :k]
    cand_ious = torch.gather(iou.T, 1, topk_idxs)               # (M, K)
    mean = cand_ious.mean(dim=1)
    std = torch.sqrt((((cand_ious - mean[:, None]) ** 2).sum(dim=1)
                      / max(k - 1, 1)).clamp_min(0.0))
    thresh = mean + std + 1e-6
    is_pos = cand_ious >= thresh[:, None]

    cand_xyz = anchors[topk_idxs][..., 0:3]                     # (M, K, 3)
    local = common.rotate_points_along_z(
        cand_xyz - gt_boxes[:, None, 0:3], -gt_boxes[:, 6])
    xy_local = local[..., 0:2]
    lw = gt_boxes[:, None, 3:5].flip(-1)                        # (M, 1, 2)
    is_in = ((xy_local <= lw / 2) & (xy_local >= -lw / 2)).all(dim=-1)
    is_pos = is_pos & is_in & gt_mask[:, None]

    pos_nm = torch.zeros((n, m), dtype=torch.bool, device=dev)
    cols = torch.arange(m, device=dev)[:, None].expand(m, k)
    pos_nm[topk_idxs.reshape(-1)[is_pos.reshape(-1)],
           cols.reshape(-1)[is_pos.reshape(-1)]] = True
    iou_inf = torch.where(pos_nm, iou, -big)
    best_val, best_gt = iou_inf.max(dim=1)

    # force-match every valid gt's best anchor; of the gts sharing one, the
    # last valid gt takes it (JAX sets them in gt order)
    a_star = iou.argmax(dim=0)                                   # (M,)
    gt_idx = torch.arange(m, device=dev)
    overridden = ((a_star[None, :] == a_star[:, None])
                  & (gt_idx[None, :] > gt_idx[:, None])
                  & gt_mask[None, :]).any(dim=1)
    win = gt_idx[gt_mask & ~overridden]
    best_gt[a_star[win]] = win
    best_val[a_star[win]] = iou[a_star[win], win]

    matched = best_val > -big / 2
    labels = torch.where(matched & gt_mask[best_gt], gt_cls[best_gt], 0)
    targets = box_coder.encode(gt_boxes[best_gt], anchors)
    pos = labels > 0
    targets = torch.where(pos[:, None], targets, 0.0)
    unc = torch.where(pos[:, None], gt_uncertainty[best_gt], 1.0)
    return TargetDict(
        box_cls_labels=labels.to(torch.int32),
        box_reg_targets=targets,
        reg_weights=pos.to(torch.float32),
        label_uncertainty=unc)
