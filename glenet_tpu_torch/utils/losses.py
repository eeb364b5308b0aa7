"""Detection losses of the GLENet-VR train step (torch counterparts of
glenet_tpu/utils/losses.py): focal classification, sin-difference smooth-L1
regression with per-code weights and the NaN-target rule, direction-bin
cross entropy and the corner loss."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import box_utils


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
