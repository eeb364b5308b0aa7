"""Waymo detection metrics (mAP / mAPH at LEVEL_1 / LEVEL_2): the port's
counterpart of glenet_tpu/eval/waymo_eval.py, a numpy re-implementation of
the protocol the reference wraps through TF's `detection_metrics`:

  - 3D IoU matching, per-class thresholds Vehicle 0.7 / Pedestrian 0.5 /
    Truck 0.5 / Cyclist 0.5;
  - gt difficulty: the annotator's level, else 2 if num_points_in_gt <= 5
    else 1; gts without points dropped;
  - LEVEL_1 scores only difficulty-1 gts (a detection matched to a
    difficulty-2 gt is neither TP nor FP), LEVEL_2 scores all gts;
  - a PR curve over 101 score cutoffs, precision made monotone, AP the area
    under it; APH weighs each true positive by its heading accuracy
    (1 - |wrapped heading error| / pi).

At every cutoff the surviving detections of a frame are matched one to one
to its gts by Hungarian assignment (scipy's linear_sum_assignment)
maximising the total IoU over the pairs above the class threshold; frames
whose det x gt pair count exceeds HUNGARIAN_BUDGET fall back to greedy
score-ordered matching.

The 3D IoUs of every frame of a class are computed in one batch of
row-aligned box pairs on `device` (the GPU by default) with the port's
ops/iou3d.py; matching and the curves stay on the host.

Annos are per-frame dicts: 'name', 'boxes_lidar' ((N, 7) centre boxes),
'score' (detections), optional 'num_points_in_gt' / 'difficulty' (gts).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import iou3d
from ..utils.common import resolve_device

CLASS_IOU = {'Vehicle': 0.7, 'Pedestrian': 0.5, 'Truck': 0.5,
             'Cyclist': 0.5}
N_CUTOFFS = 101
# above this det x gt pair count, per-cutoff Hungarian falls back to greedy
HUNGARIAN_BUDGET = 250_000
# box pairs per IoU launch on the device
IOU_CHUNK = 1 << 20


def frame_ious(pairs, device):
    """[(boxes_a (n, 7), boxes_b (m, 7)) per frame] -> [(n, m) 3D IoU as
    float32 numpy per frame], all frames' pairs in chunks of row-aligned
    boxes on `device`."""
    sizes = [len(a) * len(b) for a, b in pairs]
    if not sum(sizes):
        return [np.zeros((len(a), len(b)), np.float32) for a, b in pairs]
    rows_a = np.concatenate([np.repeat(a, len(b), axis=0)
                             for a, b in pairs]).astype(np.float32)
    rows_b = np.concatenate([np.tile(b, (len(a), 1))
                             for a, b in pairs]).astype(np.float32)
    ta = torch.from_numpy(rows_a).to(device)
    tb = torch.from_numpy(rows_b).to(device)
    iou = torch.cat([iou3d.boxes_aligned_iou3d(x, y) for x, y in
                     zip(ta.split(IOU_CHUNK), tb.split(IOU_CHUNK))])
    flat = iou.cpu().numpy()
    out, s = [], 0
    for (a, b), n in zip(pairs, sizes):
        out.append(flat[s:s + n].reshape(len(a), len(b)))
        s += n
    return out


def _heading_accuracy(dh):
    dh = np.abs((dh + np.pi) % (2 * np.pi) - np.pi)
    return np.clip(1.0 - dh / np.pi, 0.0, 1.0)


def _match_once(gain, hungarian):
    """One-to-one matching of a (nd, ng) gain matrix (IoU where the pair
    clears the class threshold, else 0) -> the matched gt per det (-1
    unmatched).  Hungarian maximises the total matched IoU; the greedy
    fallback walks the rows (sorted by score) in order."""
    nd, ng = gain.shape
    match = np.full(nd, -1, np.int64)
    if hungarian:
        from scipy.optimize import linear_sum_assignment
        rows, cols = linear_sum_assignment(gain, maximize=True)
        hit = gain[rows, cols] > 0.0
        match[rows[hit]] = cols[hit]
        return match
    taken = np.zeros(ng, bool)
    for d in range(nd):
        cand = np.where(~taken & (gain[d] > 0.0))[0]
        if cand.size:
            g = cand[np.argmax(gain[d][cand])]
            match[d] = g
            taken[g] = True
    return match


def _gt_difficulty(anno, mask):
    diff = np.asarray(anno.get('difficulty',
                               np.zeros(mask.sum(), np.int64)))
    if diff.shape[0] != mask.sum():
        diff = diff[mask]
    diff = diff.copy()
    npts = anno.get('num_points_in_gt')
    if npts is not None:
        npts = np.asarray(npts)[mask] if np.asarray(npts).shape[0] != \
            mask.sum() else np.asarray(npts)
        zero = diff == 0
        diff[(npts > 5) & zero] = 1
        diff[(npts <= 5) & zero] = 2
    else:
        diff[diff == 0] = 1
    return diff


def _ap_from_curve(recalls, precisions):
    order = np.argsort(recalls)
    r = np.concatenate([[0.0], recalls[order], [recalls[order][-1]]]) \
        if len(recalls) else np.array([0.0])
    p = np.concatenate([[0.0], precisions[order], [0.0]]) \
        if len(precisions) else np.array([0.0])
    # monotone precision from the high-recall end
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


def class_frames(det_annos, gt_annos, class_name):
    """Per frame: the class's detections sorted by score (boxes, scores)
    and its gts with points (boxes, difficulty)."""
    frames = []
    for det, gt in zip(det_annos, gt_annos):
        gmask = np.asarray([n == class_name for n in gt['name']], bool)
        gboxes = np.asarray(gt['boxes_lidar']).reshape(len(gmask), -1) \
            if len(gmask) else np.zeros((0, 7))
        gboxes = gboxes[:, :7][gmask]
        diff = _gt_difficulty(gt, gmask)
        npts = gt.get('num_points_in_gt')
        if npts is not None:
            keep = np.asarray(npts)[gmask] > 0
            gboxes, diff = gboxes[keep], diff[keep]
        dmask = np.asarray([n == class_name for n in det['name']], bool)
        dboxes = np.asarray(det['boxes_lidar']).reshape(len(dmask), -1) \
            if len(dmask) else np.zeros((0, 7))
        dboxes = dboxes[:, :7][dmask]
        dscores = np.asarray(det['score'])[dmask]
        order = np.argsort(-dscores)
        frames.append((dboxes[order], dscores[order], gboxes, diff))
    return frames


def evaluate_class(det_annos, gt_annos, class_name, levels=(1, 2),
                   device=None):
    """{level: (AP, APH)} for one class.  Matching is level-independent
    (eligibility only classifies matches afterwards), so both difficulty
    levels share one IoU matrix and one solve per frame and cutoff."""
    device = resolve_device(device)
    iou_thresh = CLASS_IOU[class_name]
    cutoffs = np.linspace(0.0, 1.0, N_CUTOFFS)
    tp = {lv: np.zeros(N_CUTOFFS) for lv in levels}
    tp_h = {lv: np.zeros(N_CUTOFFS) for lv in levels}
    n_det = {lv: np.zeros(N_CUTOFFS) for lv in levels}
    n_gt_eligible = {lv: 0 for lv in levels}
    frames = class_frames(det_annos, gt_annos, class_name)
    ious = frame_ious([(d, g) for d, _, g, _ in frames], device)
    for (dboxes, dscores, gboxes, diff), iou in zip(frames, ious):
        eligible = {lv: diff <= lv for lv in levels}
        for lv in levels:
            n_gt_eligible[lv] += int(eligible[lv].sum())
        nd, ng = len(dboxes), len(gboxes)
        if nd == 0:
            continue
        if ng:
            gain = np.where(iou >= iou_thresh, iou, 0.0)
            ha = _heading_accuracy(dboxes[:, 6:7] - gboxes[None, :, 6])
        hungarian = nd * ng <= HUNGARIAN_BUDGET
        # number of dets surviving each cutoff (scores sorted descending);
        # matching depends only on that count, so cache per count
        counts = np.searchsorted(-dscores, -cutoffs, side='right')
        by_count = {}
        for ci in range(N_CUTOFFS):
            k = int(counts[ci])
            if k == 0:
                continue
            if ng == 0:
                for lv in levels:
                    n_det[lv][ci] += k
                continue
            if k not in by_count:
                match = _match_once(gain[:k], hungarian)
                per_level = {}
                for lv in levels:
                    is_tp = (match >= 0) & \
                        eligible[lv][np.clip(match, 0, None)]
                    ignored = (match >= 0) & \
                        ~eligible[lv][np.clip(match, 0, None)]
                    hsum = float(ha[np.arange(k)[is_tp],
                                    match[is_tp]].sum())
                    per_level[lv] = (int(is_tp.sum()), hsum,
                                     k - int(ignored.sum()))
                by_count[k] = per_level
            for lv in levels:
                t, th, n = by_count[k][lv]
                tp[lv][ci] += t
                tp_h[lv][ci] += th
                n_det[lv][ci] += n

    out = {}
    for lv in levels:
        if n_gt_eligible[lv] == 0:
            out[lv] = (0.0, 0.0)
            continue
        valid = n_det[lv] > 0
        recalls = tp[lv][valid] / n_gt_eligible[lv]
        precisions = tp[lv][valid] / n_det[lv][valid]
        precisions_h = tp_h[lv][valid] / n_det[lv][valid]
        out[lv] = (_ap_from_curve(recalls, precisions) * 100.0,
                   _ap_from_curve(recalls, precisions_h) * 100.0)
    return out


def evaluate_class_level(det_annos, gt_annos, class_name, level,
                         device=None):
    """AP and APH for one class at one difficulty level."""
    return evaluate_class(det_annos, gt_annos, class_name, levels=(level,),
                          device=device)[level]


def waymo_evaluation(det_annos, gt_annos, class_names, device=None):
    """-> (result_str, ret_dict) in the reference's key style:
    'OBJECT_TYPE_TYPE_{CLS}_LEVEL_{1,2}/AP' and '/APH'."""
    ret = {}
    lines = []
    for cls in class_names:
        if cls not in CLASS_IOU:
            continue
        by_level = evaluate_class(det_annos, gt_annos, cls, device=device)
        for level, (ap, aph) in sorted(by_level.items()):
            key = f'OBJECT_TYPE_TYPE_{cls.upper()}_LEVEL_{level}'
            ret[f'{key}/AP'] = ap
            ret[f'{key}/APH'] = aph
            lines.append(f'{key}: AP {ap:.4f}  APH {aph:.4f}')
    return '\n'.join(lines), ret
