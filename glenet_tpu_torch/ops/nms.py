"""Fixed-slot NMS (torch counterpart of glenet_tpu/ops/nms.py).

  1. small candidate counts: the full (P, P) rotated-IoU matrix once, then
     greedy suppression as parallel locally-first confirmation rounds
     (`greedy_keep`);
  2. large counts (proposal NMS): a lazy kept-buffer pass over blocks of 256
     score-ordered candidates (`_greedy_keep_lazy`) that stops once
     `post_max` boxes are kept or the live candidates run out;
  3. variance voting vectorized after the keep pass;
  4. `nms_normal` (axis-aligned IoU) and `soft_nms` (score rescaling),
     which glenet_tpu offers beside them; no NMS_TYPE selects them.

Outputs are fixed-shape: (post_max,) indices + validity (+ voted boxes).
Candidates are ordered by a STABLE descending sort of the scores, so ties
keep the lower index first, as in the JAX package.  The loops' exit tests
read one flag from the device per iteration (a host sync).
"""
from __future__ import annotations

import math

import torch

from ..utils import trace
from . import iou3d


def _topk_boxes(boxes, scores, pre_max):
    order = torch.argsort(-scores, stable=True)[:pre_max]
    return boxes[order], scores[order], order


def _fixpoint_keep(a, live):
    """Exact greedy keep via parallel locally-first-confirmation rounds: per
    round every candidate with NO earlier undecided suppressor is decided —
    kept iff no confirmed keep suppresses it.  Rounds = max suppression-chain
    depth; 8 rounds per host check.

    a: (P, P) bool with a[j, i] = "j suppresses i AND j earlier than i".
    """
    undecided = live.clone()
    keep = torch.zeros_like(live)
    while bool(undecided.any()):
        trace.count('host_waits')
        for _ in range(8):
            blocked = (a & undecided[:, None]).any(dim=0)
            new_keep = undecided & ~blocked
            keep = keep | new_keep
            new_supp = (a & new_keep[:, None]).any(dim=0)
            undecided = undecided & ~new_keep & ~new_supp
    trace.count('host_waits')           # the read that ended the loop
    return keep


def greedy_keep(supp_mat, live):
    """Greedy NMS keep flags over score-sorted candidates.

    supp_mat: (P, P) bool — True where box row would suppress box col.
    live: (P,) bool — candidates above the score threshold.
    """
    idx = torch.arange(supp_mat.shape[0], device=supp_mat.device)
    return _fixpoint_keep(supp_mat & (idx[:, None] < idx[None, :]), live)


_LAZY_BLK = 256


def _greedy_keep_lazy(boxes_s, live, iou_threshold, post_max: int):
    """Greedy NMS keep flags without the (P, P) IoU matrix: a candidate is
    suppressed iff it overlaps a KEPT higher-scored box, and only the first
    `post_max` keeps are returned, so the kept-corner buffer is capped at
    post_max slots and the loop stops once that many are kept.

    boxes_s: (P, 7) score-sorted; live: (P,) bool, True on a prefix (the
    scores above the threshold).  Returns keep (P,) bool (entries after
    the early exit are False).
    """
    blk = _LAZY_BLK
    p0 = boxes_s.shape[0]
    pad = (-p0) % blk
    dev = boxes_s.device
    if pad:
        boxes_s = torch.cat([boxes_s, boxes_s.new_zeros((pad, 7))])
        live = torch.cat([live, live.new_zeros(pad)])
    p = p0 + pad
    corners = iou3d.box_to_bev_corners(boxes_s)                 # (P, 4, 2)
    areas = boxes_s[:, 3] * boxes_s[:, 4]
    k = post_max
    keep = torch.zeros(p, dtype=torch.bool, device=dev)
    # slot k is a dump slot for keeps past the cap
    buf_c = torch.zeros((k + 1, 4, 2), dtype=corners.dtype, device=dev)
    buf_a = torch.zeros(k + 1, dtype=areas.dtype, device=dev)
    n_kept = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.arange(k, device=dev)
    # the candidates are score-sorted, so the live ones are a prefix: no
    # block past it keeps a box
    trace.count('host_waits')
    for b in range(-(-int(live.sum()) // blk)):
        sl = slice(b * blk, (b + 1) * blk)
        c_blk, a_blk, live_blk = corners[sl], areas[sl], live[sl]
        ov_prev = iou3d._pairwise(c_blk, buf_c[:k])              # (blk, k)
        iou_prev = ov_prev / (a_blk[:, None] + buf_a[None, :k]
                              - ov_prev).clamp_min(1e-6)
        # unfilled buffer slots hold degenerate zero-corner quads
        filled = slots < n_kept
        free = live_blk & ~((iou_prev > iou_threshold)
                            & filled[None, :]).any(dim=1)
        ov_blk = iou3d._pairwise(c_blk, c_blk)
        iou_blk = ov_blk / (a_blk[:, None] + a_blk[None, :]
                            - ov_blk).clamp_min(1e-6)
        keep_blk = greedy_keep(iou_blk > iou_threshold, free)
        rank = torch.cumsum(keep_blk.long(), 0) - 1
        slot = torch.where(keep_blk, n_kept + rank, k).clamp_max(k)
        buf_c[slot] = c_blk
        buf_a[slot] = a_blk
        keep[sl] = keep_blk
        n_kept = n_kept + keep_blk.sum()
        trace.count('host_waits')
        if int(n_kept) >= k:
            break
    return keep[:p0]


def _first_k_kept(keep, k):
    """Indices of the first k True entries of `keep` (score order) +
    validity, fixed shape via a rank scatter with a dump slot."""
    p = keep.shape[0]
    rank = torch.cumsum(keep.long(), 0) - 1
    slot = torch.where(keep & (rank < k), rank, k)
    idx = torch.zeros(k + 1, dtype=torch.int64, device=keep.device)
    idx[slot] = torch.arange(p, device=keep.device)
    valid = torch.arange(k, device=keep.device) < keep.sum()
    return idx[:k], valid


def nms_bev(boxes, scores, iou_threshold, pre_max: int = 4096,
            post_max: int = 500, score_threshold: float = 0.0):
    """Greedy rotated-BEV-IoU NMS over (N, 7) boxes and (N,) scores.

    Returns keep_idx (post_max,) int64 indices into the inputs and
    keep_valid (post_max,) bool.
    """
    pre_max = min(pre_max, boxes.shape[0])
    boxes_s, scores_s, order = _topk_boxes(boxes, scores, pre_max)
    live = scores_s > score_threshold
    if pre_max <= 2 * _LAZY_BLK:
        iou = iou3d.boxes_iou_bev_blocked(boxes_s, boxes_s)
        keep = greedy_keep(iou > iou_threshold, live)
    else:
        keep = _greedy_keep_lazy(boxes_s, live, iou_threshold, post_max)
    keep_idx, keep_valid = _first_k_kept(keep, post_max)
    return order[keep_idx], keep_valid


def nms_normal(boxes, scores, iou_threshold, pre_max: int = 4096,
               post_max: int = 500, score_threshold: float = 0.0):
    """Greedy NMS on axis-aligned BEV IoU, the headings ignored (the
    reference's nms_normal_gpu): the (P, P) IoU matrix of the pre_max
    candidates, then greedy_keep.  Returns keep_idx (post_max,) and
    keep_valid (post_max,) as nms_bev."""
    from ..utils import box_utils
    pre_max = min(pre_max, boxes.shape[0])
    boxes_s, scores_s, order = _topk_boxes(boxes, scores, pre_max)
    aligned = torch.cat([boxes_s[:, 0:2] - boxes_s[:, 3:5] / 2,
                         boxes_s[:, 0:2] + boxes_s[:, 3:5] / 2], dim=1)
    live = scores_s > score_threshold
    iou = box_utils.boxes_iou_normal(aligned, aligned)
    keep = greedy_keep(iou > iou_threshold, live)
    keep_idx, keep_valid = _first_k_kept(keep, post_max)
    return order[keep_idx], keep_valid


_NEG_INF = -1e9


def soft_nms(boxes, scores, score_threshold: float = 0.1,
             soft_sigma: float = 0.3, soft_mode: str = 'gaussian',
             pre_max: int = 1024, post_max: int = 256):
    """Soft-NMS (the reference's softnms, without voting) over the pre_max
    top-scored boxes: post_max rounds, each keeping the live box of the
    highest rescaled score (the first on a tie, as argmax) and rescaling the
    others by exp(-iou^2 / sigma) ('gaussian') or by 1 - iou where iou >=
    sigma ('linear'), rotated BEV IoU; a box whose score falls below
    score_threshold leaves.  No host sync.

    Returns keep_idx (post_max,) into the inputs, keep_valid (post_max,)
    and keep_scores (post_max,), the rescaled score of each keep (0 in an
    empty slot, whose index is order[0])."""
    pre_max = min(pre_max, boxes.shape[0])
    boxes_s, scores_s, order = _topk_boxes(boxes, scores, pre_max)
    iou_mat = iou3d.boxes_iou_bev_blocked(boxes_s, boxes_s)
    live = torch.where(scores_s >= score_threshold, scores_s, _NEG_INF)
    dev = boxes.device
    keep_idx = torch.zeros(post_max, dtype=torch.int64, device=dev)
    keep_valid = torch.zeros(post_max, dtype=torch.bool, device=dev)
    keep_scores = torch.zeros(post_max, dtype=scores.dtype, device=dev)
    for k in range(post_max):
        i = torch.argmax(live)
        cur = live[i]
        valid = cur > _NEG_INF / 2
        iou = iou_mat[i]
        if soft_mode == 'gaussian':
            scale = torch.exp(-iou ** 2 / soft_sigma)
        else:
            scale = torch.where(iou >= soft_sigma, 1.0 - iou, 1.0)
        live = torch.where(valid, live * scale, live)
        live = torch.where(live < score_threshold, _NEG_INF, live)
        live = live.index_fill(0, i.reshape(1), _NEG_INF)
        keep_idx[k] = torch.where(valid, i, 0)
        keep_valid[k] = valid
        keep_scores[k] = torch.where(valid, cur, 0.0)
    return order[keep_idx], keep_valid, keep_scores


def multi_classes_nms(boxes, cls_scores, iou_threshold, num_class: int,
                      pre_max: int = 1024, post_max: int = 128,
                      score_threshold: float = 0.0):
    """Per-class NMS: nms_bev of class k over every box scored by class k,
    then the num_class * post_max slots merged by a stable descending sort
    of their scores (empty slots score 0 and keep their order).

    Args: boxes (N, 7); cls_scores (N, num_class).
    Returns keep_idx (num_class * post_max,), keep_valid, keep_labels
    (1-based), keep_scores, sorted by score descending.
    """
    idx, valid, scores, labels = [], [], [], []
    for k in range(num_class):
        sk = cls_scores[:, k]
        i, v = nms_bev(boxes, sk, iou_threshold, pre_max=pre_max,
                       post_max=post_max, score_threshold=score_threshold)
        idx.append(i)
        valid.append(v)
        scores.append(torch.where(v, sk[i], 0.0))
        labels.append(torch.full((post_max,), k + 1, dtype=torch.int64,
                                 device=boxes.device))
    idx, valid, scores, labels = (torch.cat(t) for t in (idx, valid, scores,
                                                         labels))
    order = torch.argsort(-scores, stable=True)
    return idx[order], valid[order], labels[order], scores[order]


def variance_voting_nms(boxes, scores, variance, iou_threshold,
                        pre_max: int = 4096, post_max: int = 500,
                        score_threshold: float = 0.0,
                        std_iou_sigma: float = 0.05):
    """GLENet variance-voting NMS (fixed slots).

    Per kept box, its cluster is every live box with IoU(original) >
    thresh; member headings are shifted +-2*pi toward the top box when
    |dh| >= 3*pi/2; per-dim weights exp(-(1-iou)^2/sigma) / var, the heading
    weight zeroed where |dh| >= pi/4; the kept box becomes the weighted
    average of its cluster.  Headings must be pre-wrapped by the caller.

    Args: boxes (N, 7), scores (N,), variance (N, 7).
    Returns keep_idx (post_max,), keep_valid (post_max,), voted_boxes
    (post_max, 7), keep_scores (post_max,).
    """
    pre_max = min(pre_max, boxes.shape[0])
    boxes_s, scores_s, order = _topk_boxes(boxes, scores, pre_max)
    var_s = variance[order]
    live = scores_s >= score_threshold
    iou = iou3d.boxes_iou_bev_blocked(boxes_s, boxes_s)         # (P, P)
    supp = iou > iou_threshold
    keep = greedy_keep(supp, live)

    # suppressor(j): the first kept box overlapping j
    p = boxes_s.shape[0]
    ar = torch.arange(p, device=boxes.device)
    member = keep[:, None] & supp & live[None, :]
    suppressor = torch.where(member, ar[:, None], p).amin(dim=0)
    in_cluster = suppressor < p
    sup_safe = torch.where(in_cluster, suppressor, 0)

    h = boxes_s[:, 6]
    h_top = h[sup_safe]
    shift = torch.where((h - h_top).abs() >= math.pi * 3 / 2,
                        torch.where(h_top > 0, 2 * math.pi, -2 * math.pi),
                        0.0)
    h_shifted = h + shift
    member_boxes = torch.cat([boxes_s[:, :6], h_shifted[:, None]], dim=1)

    iou_to_top = iou.gather(0, sup_safe[None, :])[0]
    w_iou = torch.exp(-(1.0 - iou_to_top) ** 2 / std_iou_sigma)[:, None]
    pi = w_iou / var_s                                          # (P, 7)
    heading_ok = (h_shifted - h_top).abs() < math.pi / 4
    pi = torch.cat([pi[:, :6],
                    torch.where(heading_ok, pi[:, 6], 0.0)[:, None]], dim=1)
    pi = torch.where(in_cluster[:, None], pi, 0.0)

    # cluster sums as a one-hot product: deterministic, unlike an
    # index_add_ with repeated targets
    onehot = (sup_safe[None, :] == ar[:, None]).to(pi.dtype)   # (P, P)
    num = onehot @ torch.where(in_cluster[:, None], pi * member_boxes, 0.0)
    den = onehot @ pi
    voted_all = num / den.clamp_min(1e-20)

    keep_idx, keep_valid = _first_k_kept(keep, post_max)
    voted = torch.where(keep_valid[:, None], voted_all[keep_idx], 0.0)
    kept_scores = torch.where(keep_valid, scores_s[keep_idx], 0.0)
    return order[keep_idx], keep_valid, voted, kept_scores
