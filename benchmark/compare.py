"""The numbers compared with the reference, each the worst over what a run
checks.  The cell's limits file names the ones that decide `correct`; the
others are printed in the readings of benchmark/control.py.

Training (the window's first steps against the reference's):
  - bn1_gap: per BN statistic (running mean or variance of a layer), the
    norm of the difference of the first step's updates over the norm of
    the reference's update, worst leaf: the first forward's batch moments
    of every layer, as the state records them;
  - change_gap: per leaf, | ||change|| - ||reference change|| | over
    max(||reference change||, the median leaf's), worst leaf, of the
    change over the checked steps (parameters and BN statistics); a
    parameter whose reference gradient is under a thousandth of the
    median leaf's is left out (Adam moves it by rounding alone);
  - loss1_gap / loss_gap: |loss - reference loss| / |reference loss| of
    the first step / the worst step; terms1_gap: the same of each loss
    term of the first step (focal, the KL-label's three parts, direction
    bins), the worst term;
  - grad_gap: the same gap of norms as change_gap, of the first step's
    gradient as the optimizer got it (after the clip), the program's
    worked out from its first moment after that step; grad_median: that
    gap at the median leaf;
  - grad_dir_median: per leaf, the norm of the difference of the first
    gradients over max(the reference's norm, the median leaf's), at the
    median leaf; kernel_grad_dir: the same, worst over the kernels (leaves
    of two or more axes); change_dir_median: the same of the change over
    the checked steps: these see a direction, not only a norm;
  - frozen_share: per kernel, of the entries the reference moved by at
    least the kernel's median change, the share the program moved by
    under a tenth of that median; the worst kernel (entries a backward
    left without gradient, which Adam does not move).

Detection (sampled requests against the reference on the same frames):
each of the program's boxes is matched to the reference's decoded box of
the same class nearest to it (centre in cells, z, log sizes, score) among
the reference's best (cell, class) pairs;
  - map_rms: the root mean square over the boxes of the differences in
    the head's map units (centre offsets in cells, z, log sizes, and
    |rot| * sin(angle difference) for the heading); map_gap: the largest;
  - score_rms: the root mean square of the score differences;
  - nms_faults: the program's final set checked as a greedy NMS over the
    reference's candidates (its top_k (cell, class) pairs), up to
    rounding: `foreign` boxes (no candidate within TOL_MAP and TOL_SCORE,
    outside the top_k, under the score threshold, or a candidate twice),
    `overlap` (kept pairs of IoU over NMS_THRESH + TOL_IOU) and `missing`
    candidates (scored above the threshold, left out, and suppressed by no
    kept box of no lower score at IoU over NMS_THRESH - TOL_IOU); their
    sum.  IoUs are the reference's (polygon clipping in float64);
  - printed for the look: count_gap (the difference of the numbers of
    final boxes), kept_diff (candidates kept by one side only),
    ref_suppressed (live candidates the reference's NMS suppressed).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import waymo_centerpoint as ref_cp

BN_STATS = ('running_mean', 'running_var')
LOSS_TERMS = ('loss_cls', 'loc_loss_src', 'loc_loss_square', 'loc_loss_log',
              'loss_dir')
TOL_MAP = 0.05      # map units: a box is its candidate when this close
TOL_SCORE = 3e-4    # score band at the top-k cut and the score threshold
TOL_IOU = 0.01      # IoU band around NMS_THRESH that rounding may decide


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tensors.items()}


def _worst_gap(prog, ref, keys):
    """max over keys of |prog - ref| / max(ref, median ref)."""
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def train_numbers(prog, ref, init):
    """prog / ref: dicts with losses [..], terms1 {term: value} (the first
    step's loss terms), grads {leaf: tensor} (first step, after the clip),
    final {leaf: tensor} (parameters and BN statistics after the checked
    steps), bn1 {leaf: tensor} (the BN running statistics after the first
    step); init: the weights before."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog['losses'],
                                                ref['losses'])]
    leaves = sorted(ref['grads'])
    g_ref, g_prog = _norms(ref['grads']), _norms(prog['grads'])
    med = float(np.median([g_ref[k] for k in leaves]))
    g_dir = {k: float(torch.linalg.vector_norm(
        (prog['grads'][k] - ref['grads'][k]).float()))
        / max(g_ref[k], med, 1e-30) for k in leaves}
    moved = [k for k in leaves if g_ref[k] >= 1e-3 * med]
    moved += [k for k in ref['final'] if k not in ref['grads']]
    d_ref = _norms({k: ref['final'][k] - init[k] for k in moved})
    d_prog = _norms({k: prog['final'][k] - init[k] for k in moved})
    d_med = float(np.median([d_ref[k] for k in moved]))
    d_dir = [float(torch.linalg.vector_norm(
        (prog['final'][k] - ref['final'][k]).float()))
        / max(d_ref[k], d_med, 1e-30) for k in moved]
    frozen = 0.0
    for k in moved:
        if k in ref['grads'] and ref['grads'][k].dim() >= 2:
            dr = (ref['final'][k] - init[k]).abs().flatten()
            dp = (prog['final'][k] - init[k]).abs().flatten()
            med_k = dr.median()
            big = dr >= med_k
            frozen = max(frozen, float((dp[big] < 0.1 * med_k).float().mean()))
    bn1_gap = max(
        float(torch.linalg.vector_norm(prog['bn1'][k] - ref['bn1'][k])
              / torch.linalg.vector_norm(ref['bn1'][k] - init[k]).clamp_min(
                  1e-30))
        for k in ref['bn1'])
    return {'bn1_gap': bn1_gap,
            'change_gap': _worst_gap(d_prog, d_ref, moved),
            'change_dir_median': float(np.median(d_dir)),
            'frozen_share': frozen,
            'loss1_gap': gaps[0], 'loss_gap': max(gaps),
            'terms1_gap': max(abs(prog['terms1'][t] - ref['terms1'][t])
                              / max(abs(ref['terms1'][t]), 1e-30)
                              for t in LOSS_TERMS),
            'grad_gap': _worst_gap(g_prog, g_ref, leaves),
            'grad_median': float(np.median(
                [abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med, 1e-30)
                 for k in leaves])),
            'grad_dir_median': float(np.median([g_dir[k] for k in leaves])),
            'kernel_grad_dir': max(g_dir[k] for k in leaves
                                   if ref['grads'][k].dim() >= 2)}


def _wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


class _Iou:
    """Rotated BEV IoU of candidate pairs by the reference's polygon
    clipping (float64), cached."""

    def __init__(self, boxes):
        self.b = boxes
        self.corners = ref_cp.bev_corners(boxes)
        self.radius = 0.5 * np.hypot(boxes[:, 3], boxes[:, 4])
        self.area = boxes[:, 3] * boxes[:, 4]
        self.cache = {}

    def near(self, i, js):
        """The candidates of js whose BEV circles meet i's."""
        js = np.asarray(js, dtype=np.int64)
        d = np.hypot(self.b[js, 0] - self.b[i, 0],
                     self.b[js, 1] - self.b[i, 1])
        return [int(j) for j in js[d <= self.radius[i] + self.radius[js]]]

    def __call__(self, i, j):
        key = (min(i, j), max(i, j))
        if key not in self.cache:
            inter = ref_cp.clip_area(self.corners[i], self.corners[j])
            self.cache[key] = inter / max(
                self.area[i] + self.area[j] - inter, 1e-6)
        return self.cache[key]


def detection_numbers(prog, ref, cell_m, nms, n_candidates=4000):
    """prog: final boxes (n, 7), scores (n,), labels (n,) of one request
    (valid ones only, numpy); ref: waymo_centerpoint.predict's dict;
    cell_m: metres of one map cell; nms: thresh, score_thresh, top_k and
    post_max of the configuration's post-processing."""
    scores = ref['all_scores']
    c = scores.shape[1]
    val, idx = torch.sort(scores.reshape(-1), descending=True, stable=True)
    idx = idx[:n_candidates]
    cells, cls = (idx // c).cpu().numpy(), (idx % c + 1).cpu().numpy()
    cand = ref['all_boxes'][idx // c].cpu().numpy().astype(np.float64)
    cand_s = val[:n_candidates].cpu().numpy().astype(np.float64)
    rot = ref['all_rot'].cpu().numpy()[cells]
    rot_len = np.hypot(rot[:, 0], rot[:, 1])
    top_k, thresh = int(nms['top_k']), float(nms['thresh'])
    s_min, s_cut = float(nms['score_thresh']), float(cand_s[top_k - 1])
    out = {'map_gap': 0.0, 'foreign': 0, 'overlap': 0, 'missing': 0,
           'count_gap': abs(len(prog['scores']) - len(ref['scores']))}
    sq_map, sq_score, kept = [], [], {}
    for box, score, label in zip(prog['boxes'].astype(np.float64),
                                 prog['scores'], prog['labels']):
        same = np.nonzero(cls == label)[0]
        if len(same) == 0:
            out['foreign'] += 1
            out['map_gap'] = math.inf
            continue
        d = np.stack([(cand[same, 0] - box[0]) / cell_m,
                      (cand[same, 1] - box[1]) / cell_m,
                      cand[same, 2] - box[2],
                      np.log(cand[same, 3] / box[3]),
                      np.log(cand[same, 4] / box[4]),
                      np.log(cand[same, 5] / box[5]),
                      rot_len[same] * np.sin(_wrap(cand[same, 6] - box[6])),
                      10.0 * (cand_s[same] - score)], 1)
        j = int(np.argmin((d * d).sum(1)))
        r = int(same[j])
        out['map_gap'] = max(out['map_gap'], float(np.abs(d[j, :7]).max()))
        sq_map.append(float(np.mean(d[j, :7] ** 2)))
        sq_score.append((float(cand_s[r]) - float(score)) ** 2)
        outside = r >= top_k and cand_s[r] < s_cut - TOL_SCORE
        dead = cand_s[r] <= s_min - TOL_SCORE
        if (np.abs(d[j, :7]).max() > TOL_MAP or abs(cand_s[r] - score)
                > TOL_SCORE or outside or dead or r in kept):
            out['foreign'] += 1
        else:
            kept[r] = float(score)
    out['map_rms'] = math.sqrt(np.mean(sq_map)) if sq_map else 0.0
    out['score_rms'] = math.sqrt(np.mean(sq_score)) if sq_score else 0.0
    iou = _Iou(cand[:max([top_k] + [r + 1 for r in kept])])
    ks = sorted(kept)
    # no pair the program kept overlaps by more than the threshold
    for a, i in enumerate(ks):
        out['overlap'] += sum(int(iou(i, j) > thresh + TOL_IOU)
                              for j in iou.near(i, ks[a + 1:]))
    # each live candidate it left out is suppressed by a kept box of no
    # lower score; free are the scores in the band at the top-k cut or at
    # the score threshold and, with post_max boxes kept, under the lowest
    floor = max(s_cut, s_min) + TOL_SCORE
    if len(prog['scores']) >= int(nms['post_max']) and kept:
        floor = max(floor, min(kept.values()) + TOL_SCORE)
    for r in range(top_k):
        if r in kept or cand_s[r] <= floor:
            continue
        higher = [k for k in ks if cand_s[k] >= cand_s[r] - TOL_SCORE]
        if not any(iou(r, k) > thresh - TOL_IOU
                   for k in iou.near(r, higher)):
            out['missing'] += 1
    out['nms_faults'] = out['foreign'] + out['overlap'] + out['missing']
    # the look at where the kept sets differ: candidates that one side
    # kept and the other did not, and what the reference's NMS suppressed
    ref_kept = {int(r) for r in ref['keep']}
    out.update(kept_diff=len(ref_kept.symmetric_difference(kept)),
               ref_suppressed=int((cand_s[:top_k] > s_min).sum())
               - len(ref_kept))
    return out


def worst(readings):
    """Elementwise max over a list of {name: value}."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
