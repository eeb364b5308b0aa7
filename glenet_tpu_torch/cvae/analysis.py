"""Offline CVAE uncertainty analysis, variance against IoU (torch
counterpart of glenet_tpu/cvae/analysis.py).  From the K stochastic
prediction passes per object it derives

  - the per-dim variance of the gt-centred residual boxes (heading aligned
    to the gt and sin-mapped);
  - the mean 3D IoU of the sampled boxes against the gt box, through
    ops/iou3d.py::boxes_aligned_iou3d on the caller's device;
  - a Gaussian NLL score 0.5 * smoothL1(residual) / var + 0.5 * log(var),
    averaged over objects and passes (lower is better calibrated);
  - Pearson correlations of the mean variance with the IoU and with the
    point count (ambiguous objects with few points carry a high label
    variance).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.common import limit_period_np, resolve_device


def _smooth_l1(x, beta=1.0 / 9.0):
    ax = np.abs(x)
    return np.where(ax < beta, 0.5 * ax ** 2 / beta, ax - 0.5 * beta)


def residual_samples(per_pass_results):
    """key -> (K, 7) gt-centred residuals (xyz and dims minus the gt, sin
    of the heading difference)."""
    out = {}
    for key in per_pass_results[0]:
        preds = np.stack([r[key]['pred_box'][:7] for r in per_pass_results
                          if key in r]).astype(np.float64)
        gt = np.asarray(per_pass_results[0][key]['gt_box'][:7], np.float64)
        res = preds.copy()
        res[:, :6] -= gt[:6]
        res[:, 6] = np.sin(limit_period_np(preds[:, 6] - gt[6], 0, 2 * np.pi))
        out[key] = res
    return out


def mean_iou_to_gt(per_pass_results, device=None):
    """key -> mean 3D IoU of the K sampled boxes against the gt box, on
    `device` (the GPU when None; without one it raises unless given
    'cpu')."""
    from ..ops.iou3d import boxes_aligned_iou3d
    device = resolve_device(device)
    keys = list(per_pass_results[0].keys())
    preds_all, gts_all, counts = [], [], []
    for key in keys:
        p = np.stack([r[key]['pred_box'][:7] for r in per_pass_results
                      if key in r])
        preds_all.append(p)
        gts_all.append(np.tile(per_pass_results[0][key]['gt_box'][None, :7],
                               (len(p), 1)))
        counts.append(len(p))

    def flat(arrs):
        return torch.from_numpy(
            np.concatenate(arrs).astype(np.float32)).to(device)

    vals = boxes_aligned_iou3d(flat(preds_all), flat(gts_all)).cpu().numpy()
    ious, ofs = {}, 0
    for key, c in zip(keys, counts):
        ious[key] = float(vals[ofs:ofs + c].mean())
        ofs += c
    return ious


def nll_score(residuals):
    """Gaussian NLL of each residual cloud under its own per-dim variance;
    residuals: key -> (K, 7)."""
    total, n_obj = 0.0, 0
    for res in residuals.values():
        var = res.var(axis=0) + 1e-6
        loss = 0.5 * _smooth_l1(res) / var[None] + 0.5 * np.log(var)[None]
        total += loss.sum() / res.shape[0]
        n_obj += 1
    return total / max(n_obj, 1)


def pearson(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a ** 2).sum() * (b ** 2).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def analyze(per_pass_results, point_counts=None, device=None):
    """The whole report dict.  point_counts: optional key -> int."""
    residuals = residual_samples(per_pass_results)
    ious = mean_iou_to_gt(per_pass_results, device)
    keys = list(residuals.keys())
    var_mean = np.array([residuals[k].var(axis=0).mean() for k in keys])
    iou_arr = np.array([ious[k] for k in keys])
    report = {
        'n_objects': len(keys),
        'nll': float(nll_score(residuals)),
        'mean_iou': float(iou_arr.mean()) if len(keys) else 0.0,
        'mean_variance': float(var_mean.mean()) if len(keys) else 0.0,
        'corr_variance_iou': pearson(var_mean, iou_arr),
    }
    if point_counts is not None:
        pc = np.array([point_counts[k] for k in keys], np.float64)
        report['corr_variance_pointnum'] = pearson(var_mean, np.log1p(pc))
    return report
