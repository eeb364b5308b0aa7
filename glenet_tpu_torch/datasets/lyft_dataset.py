"""Lyft Level 5 adapter and its mAP (the port's own copy of
glenet_tpu/datasets/lyft_dataset.py).

The infos have nuScenes' schema, so the adapter is NuScenesDataset with
the Lyft competition's metric instead: per class the mean over the 3D IoU
thresholds 0.5, 0.55, ..., 0.95 of the AP at each, where a frame's
detections, in descending score order, each take the free gt of their
class with the highest IoU at or above the threshold, and AP is the mean
of the precision interpolated on a 101-point recall grid.

The 3D IoUs run on the dataset's device (ops/iou3d.py), once per frame and
class; the thresholds reuse them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import iou3d
from ..utils.common import resolve_device
from .nuscenes_dataset import NuScenesDataset, _class_boxes

IOU_THRESHOLDS = np.arange(0.5, 0.951, 0.05)


class LyftDataset(NuScenesDataset):
    METRIC = 'Lyft'

    def evaluation(self, det_annos, class_names, device=None):
        """The Lyft mAP (lyft_evaluation), its 3D IoUs on `device` (the GPU
        by default)."""
        return lyft_evaluation(det_annos, self.gt_annos(), class_names,
                               device=device)


def _frame_ious(db, gb, device):
    """(D, G) 3D IoUs (float32) of one frame's detections and gts of a
    class."""
    if not (len(db) and len(gb)):
        return np.zeros((len(db), len(gb)))
    iou = iou3d.boxes_iou3d(
        torch.as_tensor(db, dtype=torch.float32, device=device),
        torch.as_tensor(gb, dtype=torch.float32, device=device))
    return iou.cpu().numpy()


def lyft_evaluation(det_annos, gt_annos, class_names, device=None):
    """(result text, dict) with each class's `<cls>_mAP` and `mAP`, in %.
    A class without gts, or with gts and no detection, scores 0 and counts
    in the mean, as glenet_tpu computes it."""
    device = resolve_device(device)
    ret = {}
    maps = []
    for cls in class_names:
        frames = []
        n_gt = 0
        for det, gt in zip(det_annos, gt_annos):
            gb, _ = _class_boxes(gt, cls)
            db, dmask = _class_boxes(det, cls)
            ds = np.asarray(det['score'])[dmask]
            n_gt += len(gb)
            frames.append((ds, _frame_ious(db, gb, device)))
        aps = []
        for th in IOU_THRESHOLDS:
            if n_gt == 0:
                continue
            scores, is_tp = [], []
            for ds, iou in frames:
                taken = np.zeros(iou.shape[1], bool)
                for d in np.argsort(-ds):
                    cand = np.where(~taken & (iou[d] >= th))[0]
                    hit = cand.size > 0
                    if hit:
                        taken[cand[np.argmax(iou[d][cand])]] = True
                    scores.append(ds[d])
                    is_tp.append(hit)
            if not scores:
                aps.append(0.0)
                continue
            scores = np.asarray(scores)
            is_tp = np.asarray(is_tp, bool)
            order = np.argsort(-scores)
            tp = np.cumsum(is_tp[order])
            fp = np.cumsum(~is_tp[order])
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1)
            r_grid = np.linspace(0, 1, 101)
            p = np.interp(r_grid, recall, precision, right=0)
            aps.append(float(p.mean()))
        cls_ap = float(np.mean(aps)) if aps else 0.0
        ret[f'{cls}_mAP'] = cls_ap * 100
        maps.append(cls_ap)
    ret['mAP'] = float(np.mean(maps)) * 100 if maps else 0.0
    lines = [f'{k}: {v:.4f}' for k, v in sorted(ret.items())]
    return '\n'.join(lines), ret
