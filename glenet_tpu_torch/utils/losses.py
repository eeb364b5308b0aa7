"""Detection losses of the train steps (torch counterparts of
glenet_tpu/utils/losses.py): focal classification, sin-difference smooth-L1
regression with per-code weights and the NaN-target rule, direction-bin
cross entropy, the corner loss, SE-SSD's od-IoU loss and GLENet's KL-label
regression loss."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import box_utils, trace


def sigmoid_bce_with_logits(logits, targets):
    """Numerically stable BCE: max(x, 0) - x * z + log1p(exp(-|x|))."""
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, targets, weights, gamma: float = 2.0,
                       alpha: float = 0.25):
    """logits / targets (B, N, C); weights (B, N) or (B, N, C) -> the
    elementwise (B, N, C) weighted focal loss."""
    p = torch.sigmoid(logits)
    alpha_weight = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - p) + (1.0 - targets) * p
    loss = (alpha_weight * torch.pow(pt, gamma)
            * sigmoid_bce_with_logits(logits, targets))
    if weights.dim() == loss.dim() - 1:
        weights = weights[..., None]
    return loss * weights


def smooth_l1(diff, beta: float = 1.0 / 9.0):
    if beta < 1e-5:
        return diff.abs()
    n = diff.abs()
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def weighted_smooth_l1(preds, targets, weights=None, beta: float = 1.0 / 9.0,
                       code_weights=None):
    """(B, N, C) elementwise smooth L1.  NaN targets count as a zero
    residual (the target takes the prediction's value)."""
    targets = torch.where(torch.isnan(targets), preds, targets)
    diff = preds - targets
    if code_weights is not None:
        if not isinstance(code_weights, torch.Tensor):
            trace.count('host_waits')   # a pageable host-to-device copy
        diff = diff * torch.as_tensor(code_weights, dtype=torch.float32,
                                      device=diff.device)
    loss = smooth_l1(diff, beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_cross_entropy(logits, one_hot_targets, weights):
    """(B, N, C) logits / one-hot targets, (B, N) weights -> (B, N)."""
    logp = F.log_softmax(logits, dim=-1)
    return -(one_hot_targets * logp).sum(dim=-1) * weights


def corner_loss_lidar(pred_boxes, gt_boxes, mask=None):
    """(N, 7) boxes -> (N,) corner loss: smooth L1 (beta 1) of the corner
    distances, the nearer of the gt and its pi-flipped heading, mean over
    the 8 corners."""
    pred_corners = box_utils.boxes_to_corners_3d(pred_boxes)
    gt_corners = box_utils.boxes_to_corners_3d(gt_boxes)
    gt_flip = torch.cat([gt_boxes[:, :6], gt_boxes[:, 6:7] + math.pi,
                         gt_boxes[:, 7:]], dim=1)
    gt_corners_flip = box_utils.boxes_to_corners_3d(gt_flip)
    dist = torch.minimum(
        torch.linalg.vector_norm(pred_corners - gt_corners, dim=2),
        torch.linalg.vector_norm(pred_corners - gt_corners_flip, dim=2))
    loss = smooth_l1(dist, beta=1.0).mean(dim=1)
    if mask is not None:
        loss = loss * mask
    return loss


def odiou_3d_loss(gboxes, qboxes, weights, batch_size):
    """SE-SSD's orientation-aware distance-IoU loss of row-aligned boxes
    gboxes / qboxes (N, 7) with weights (N,):

        odiou = 1 - IoU3D + d_centre^2 / diag^2 + 1.25 (1 - |cos dtheta|),

    diag the 3D diagonal of the axis-aligned rectangle around both boxes'
    BEV corners (with the height overlap as its third side); a pair with a
    non-positive size counts 0.  Returns 2 * sum(odiou * weights) /
    batch_size.  The rotated overlap is ops/iou3d.overlap_bev_corners, so
    the gradient flows through its polygon clipping."""
    from ..ops import iou3d
    g = gboxes.clamp(-200.0, 200.0)
    q = qboxes.clamp(-200.0, 200.0)
    valid = (g[:, 3:6] > 0).all(dim=1) & (q[:, 3:6] > 0).all(dim=1)

    angle_factor = 1.25 * (1.0 - torch.abs(torch.cos(q[:, 6] - g[:, 6])))

    cg = iou3d.box_to_bev_corners(g)                      # (N, 4, 2)
    cq = iou3d.box_to_bev_corners(q)
    inter_area = iou3d.overlap_bev_corners(cg, cq)
    inter_h = (torch.minimum(g[:, 2] + g[:, 5] / 2, q[:, 2] + q[:, 5] / 2)
               - torch.maximum(g[:, 2] - g[:, 5] / 2,
                               q[:, 2] - q[:, 5] / 2)).clamp_min(0)
    vol_inc = inter_area * inter_h
    vol_union = (g[:, 3] * g[:, 4] * g[:, 5] + q[:, 3] * q[:, 4] * q[:, 5]
                 - vol_inc)
    ious = vol_inc / vol_union.clamp_min(1e-7)

    all_corners = torch.cat([cg, cq], dim=1)              # (N, 8, 2)
    mbr_min = all_corners.amin(dim=1)
    mbr_max = all_corners.amax(dim=1)
    mbr_diag_bev_sq = ((mbr_max - mbr_min) ** 2).sum(dim=1)
    mbr_diag_3d_sq = mbr_diag_bev_sq + inter_h ** 2 + 1e-7
    d_center_sq = ((g[:, 0:3] - q[:, 0:3]) ** 2).sum(dim=1)

    odious = 1.0 - ious + d_center_sq / mbr_diag_3d_sq + angle_factor
    odious = torch.where(valid, odious, 0.0)
    return 2.0 * (odious * weights).sum() / batch_size


def add_sin_difference(boxes1, boxes2, dim: int = 6):
    """Heading residuals as sin(a - b) = sin a cos b - cos a sin b: the
    first term goes into boxes1, the second into boxes2."""
    a, b = boxes1[..., dim:dim + 1], boxes2[..., dim:dim + 1]
    rad_pred = torch.sin(a) * torch.cos(b)
    rad_tg = torch.cos(a) * torch.sin(b)
    return (torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]],
                      dim=-1),
            torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]],
                      dim=-1))


def kl_label_reg_loss(box_preds, box_std_preds, box_reg_targets, reg_weights,
                      label_uncertainty, code_weights=None,
                      beta: float = 1.0 / 9.0):
    """GLENet's KL regression loss against each label's variance: with the
    predicted log variance s = max(box_std_preds, -50) and the label's
    t = log(label_uncertainty + 1e-10), per anchor and code dim

        exp(-s) * smoothL1(sin-difference residual)
        + exp(t - s) * w - 0.5 * (t - s) * w,

    w the (B, N) anchor weights.  Background anchors carry a variance of 0
    (t = -23) and weight 0.  Returns (sum of the three parts, {loc_loss_src,
    loc_loss_square, loc_loss_log}: each part's sum)."""
    s = box_std_preds.clamp_min(-50.0)
    t = torch.log(label_uncertainty + 1e-10)
    preds_sin, targets_sin = add_sin_difference(box_preds, box_reg_targets)
    l1 = weighted_smooth_l1(preds_sin, targets_sin, reg_weights, beta=beta,
                            code_weights=code_weights)
    w = reg_weights[..., None]
    parts = {'loc_loss_src': (torch.exp(-s) * l1).sum(),
             'loc_loss_square': (torch.exp(t - s) * w).sum(),
             'loc_loss_log': (-0.5 * (t - s) * w).sum()}
    return (parts['loc_loss_src'] + parts['loc_loss_square']
            + parts['loc_loss_log']), parts
