"""Waymo-scale convergence harness of the port (the counterpart of the
repository's tools/convergence_waymo.py): overfit a full Waymo-range config
on 16 synthetic vehicle scenes, then score it with the port's Waymo AP /
APH evaluator (eval/waymo_eval.py).

It covers what the KITTI harness (convergence_ap.py) does not: the 150 m
grid with Waymo's level budgets, 360-degree scenes and Waymo's matching.

    python -m glenet_tpu_torch.tools.convergence_waymo [n_steps] [peak_lr]
        [model_yaml] [bn_frozen_tail] [n_holdout] [--device cpu]
        [--out FILE]

Defaults: 700 steps, peak LR 1e-3, configs/waymo_models/centerpoint.yaml,
a frozen-BN tail of 150 steps.  A 5th positional scores that many unseen scenes (seeds
10000 + s) too.  The entry '<model>_waymo', with the device's name and
power limit, is merged into CONVERGENCE_AP_TORCH.json at the repository
root (or --out).  Runs on the GPU unless --device cpu is given; without a
GPU it raises.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from .convergence_ap import (car_surface_points, device_line, fresh_detector,
                             load_cfg, make_batches, merge_entry, parse_args,
                             peak_gib, run_overfit)

N_SCENES = 16
BATCH = 2
MAX_POINTS = 24000
N_GT = 8
N_POINTS_IN_GT = 400
DEFAULT_YAML = 'configs/waymo_models/centerpoint.yaml'


def make_scene(seed):
    """Waymo-frame scene: ground at z ~ 0, 3-7 vehicles within +-55 m and
    off the ego; points x y z intensity elongation."""
    rng = np.random.RandomState(seed)
    n_veh = rng.randint(3, N_GT)
    gt = np.zeros((N_GT, 8), np.float32)
    gt_mask = np.zeros(N_GT, bool)
    placed = []
    for g in range(n_veh):
        cx, cy = 30.0 + 8.0 * g, 30.0             # fallback row off the ego
        for _ in range(20):
            tx_, ty_ = rng.uniform(-55, 55), rng.uniform(-55, 55)
            if tx_ * tx_ + ty_ * ty_ < 64:        # keep off the ego
                continue
            if all((tx_ - px) ** 2 + (ty_ - py) ** 2 > 49
                   for px, py in placed):
                cx, cy = tx_, ty_
                break
        placed.append((cx, cy))
        dims = [rng.uniform(4.0, 5.2), rng.uniform(1.8, 2.2),
                rng.uniform(1.5, 1.9)]
        gt[g] = [placed[-1][0], placed[-1][1], dims[2] / 2,
                 *dims, rng.uniform(-np.pi, np.pi), 1]
        gt_mask[g] = True

    pts = [car_surface_points(rng, gt[g, :7], n=400) for g in range(n_veh)]
    n_ground = MAX_POINTS - sum(len(p) for p in pts)
    r = np.sqrt(rng.uniform(4, 70 ** 2, n_ground))
    th = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       rng.normal(0.0, 0.05, n_ground)], 1)
    xyz = np.concatenate(pts + [ground])[:MAX_POINTS]
    extra = np.random.RandomState(seed + 1).uniform(0, 1, (len(xyz), 2))
    return np.concatenate([xyz, extra], 1).astype(np.float32), gt, gt_mask


def to_waymo_annos(boxes, scores=None, n_points=None):
    n = len(boxes)
    anno = {'name': np.array(['Vehicle'] * n),
            'boxes_lidar': np.asarray(boxes, np.float64)}
    if scores is not None:
        anno['score'] = np.asarray(scores)
    if n_points is not None:
        anno['num_points_in_gt'] = np.asarray(n_points)
    return anno


def level_telemetry(det, batch):
    """Active sites per backbone level of `batch`'s scenes by spconv's
    dilation rule, uncapped, against the level caps in force at the train
    budget; prints one line per level.  Returns [(max, cap)] per level."""
    from ..ops import sparse as sparse_ops
    from ..ops import voxelize as vox_ops
    caps = sparse_ops.level_caps(det.max_voxels_train)
    grid = tuple(int(g) for g in det.grid_size)
    grid1 = (grid[0], grid[1], grid[2] + 1)
    counts = [[] for _ in range(4)]
    for k in range(batch['points'].shape[0]):
        vox = vox_ops.voxelize(
            batch['points'][k], batch['points_mask'][k],
            voxel_size=tuple(det.voxel_size), pc_range=tuple(det.pc_range),
            grid_size=grid, max_voxels=det.max_voxels_train,
            max_points_per_voxel=det.max_points_per_voxel)
        ny, nx = grid1[1], grid1[0]
        coords = vox['voxel_coords'].long()
        mask = vox['voxel_mask']
        ids = torch.where(mask, coords[:, 0] * (ny * nx) + coords[:, 1] * nx
                          + coords[:, 2], nx * ny * grid1[2]).to(torch.int32)
        counts[0].append(int(mask.sum()))
        g = grid1
        for lvl in (1, 2, 3):
            pad = (0, 1, 1) if lvl == 3 else 1
            ids, mask = sparse_ops.strided_output_sites(
                ids, mask, g, 3, 2, pad, 8 * caps[lvl])
            g = sparse_ops.out_grid_size(g, 3, 2, pad)
            counts[lvl].append(int(mask.sum()))
    out = []
    for lvl in range(4):
        mx = max(counts[lvl])
        flag = ' OVERFLOW' if mx > caps[lvl] else ''
        print(f'level{lvl + 1} active sites max={mx} cap={caps[lvl]}{flag}',
              flush=True)
        out.append((mx, caps[lvl]))
    return out


def waymo_scores(det, scenes, batches, tag):
    """Predicts over `batches` -> the Waymo evaluation of `scenes`' Vehicles;
    prints the first batch's kept counts and top scores."""
    from ..eval import waymo_eval
    gt_annos, dt_annos = [], []
    for bi, b in enumerate(batches):
        preds = det.predict(b)
        fb, fs, fl, fv = (preds[k].cpu().numpy() for k in (
            'final_boxes', 'final_scores', 'final_labels', 'final_valid'))
        if bi == 0:
            print(f'diag {tag} batch0: kept={fv.sum(1)}, '
                  f'score_max={fs.max(1).round(3)}', flush=True)
        for k in range(fb.shape[0]):
            gt, gm = scenes[bi * BATCH + k][1], scenes[bi * BATCH + k][2]
            keep = fv[k] & (fl[k] == 1)            # Vehicle detections
            gt_annos.append(to_waymo_annos(
                gt[gm][:, :7], n_points=np.full(gm.sum(), N_POINTS_IN_GT)))
            dt_annos.append(to_waymo_annos(fb[k][keep], fs[k][keep]))
    result_str, ret = waymo_eval.waymo_evaluation(
        dt_annos, gt_annos, ['Vehicle'], device=det.device)
    print(result_str)
    return ret


def main(argv=None):
    args = parse_args(argv, default_yaml=DEFAULT_YAML, default_steps=700,
                      extra=('bn_frozen_tail', 'n_holdout'))
    cfg = load_cfg(args.model_yaml)
    post = cfg.MODEL.POST_PROCESSING
    post.SCORE_THRESH = 0.0
    if 'POST_SCORE_THRESH' in post:
        post.POST_SCORE_THRESH = 0.0
    det = fresh_detector(cfg, args.device)
    device = det.device

    scenes = [make_scene(s) for s in range(N_SCENES)]
    batches = make_batches(scenes, BATCH, MAX_POINTS, N_GT, device)
    if det.net.backbone_3d is not None:
        level_telemetry(det, batches[0])

    # after the exact BN re-estimation, fine-tune with BN frozen to those
    # moments, so that training (batch-of-2 moments) and predict (dataset
    # moments) normalise each scene alike: the shift flips direction bins
    # and lowers APH while AP stays high
    tail = 150 if args.bn_frozen_tail is None else args.bn_frozen_tail
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    _, final_loss, t0, step_ms = run_overfit(
        det, batches, args.n_steps, args.peak_lr, bn_frozen_tail=tail)

    ret = waymo_scores(det, scenes, batches, 'train')
    model_key = Path(args.model_yaml).stem + '_waymo'
    out = {
        'model': f'{model_key} (full Waymo-range config, synthetic overfit)',
        'n_scenes': N_SCENES, 'n_steps': args.n_steps,
        'bn_frozen_tail': tail,
        'final_loss': final_loss,
        'Vehicle_L1_AP': ret.get('OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP'),
        'Vehicle_L1_APH': ret.get('OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/APH'),
        'Vehicle_L2_AP': ret.get('OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/AP'),
        'wall_clock_s': round(time.time() - t0, 1),
        'device': device_line(device),
        'ms_per_step': round(step_ms, 2),
        'peak_gib': peak_gib(device),
    }

    n_holdout = args.n_holdout or 0
    if n_holdout > 0:
        hold = [make_scene(10_000 + s) for s in range(n_holdout)]
        hret = waymo_scores(det, hold, make_batches(hold, BATCH, MAX_POINTS,
                                                    N_GT, device), 'holdout')
        out['n_holdout_scenes'] = n_holdout
        out['val_Vehicle_L1_AP'] = hret.get(
            'OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP')
        out['val_Vehicle_L1_APH'] = hret.get(
            'OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/APH')
    merge_entry(model_key, out, args.out)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
