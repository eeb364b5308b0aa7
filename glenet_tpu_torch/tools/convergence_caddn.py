"""Accuracy-convergence harness of the port for CaDDN, the camera-only
family (the counterpart of the repository's tools/convergence_caddn.py):
overfit configs/kitti_models/CaDDN.yaml (ImageVFE: depth distribution ->
frustum -> voxels -> BEV collapse -> anchor head) on the 16 synthetic
scenes of convergence_ap rendered through a synthetic pinhole camera, then
score it with the port's KITTI evaluator.

    python -m glenet_tpu_torch.tools.convergence_caddn [n_steps] [peak_lr]
        [model_yaml] [--device cpu] [--out FILE]

Defaults: 700 steps, peak LR 1e-3, CaDDN.yaml.  The image is 192 x 640
(the intrinsics scaled to match, so the frustum-to-voxel geometry stays
exact); its RGB channels carry a z-buffered range image, occupancy and
point height; the depth target is the lidar z-buffer at stride 4; the 2-D
boxes bound the projected 3-D corners, at the feature map's scale for the
depth loss.  The annotations are scored through a 2x reporting camera
(EVAL_SCALE): KITTI's moderate cut drops gts under 25 pixels, which at
192 pixels of height would leave only near cars.  The entry (with the
device's name and power limit) is merged into CONVERGENCE_AP_TORCH.json
under 'CaDDN' (or --out).  Runs on the GPU unless --device cpu is given.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from . import convergence_ap as ca

H, W = 192, 640
FU = 320.0              # focal (px): a half field of view of 45 deg
CU, CV = W / 2.0, 48.0  # the horizon above the centre: ground rows in view
DS = 4                  # depth-map downsample factor
DEPTH_MAX = 46.8        # the image's range channel: depth / DEPTH_MAX
GT_MAX_X = 42.0         # gts beyond stay in the scene as unlabelled clutter

# lidar (x forward, y left, z up) -> camera (x right, y down, z forward)
L2C = np.array([[0., -1., 0., 0.],
                [0., 0., -1., 0.],
                [1., 0., 0., 0.],
                [0., 0., 0., 1.]], np.float32)
C2I = np.array([[FU, 0., CU, 0.],
                [0., FU, CV, 0.],
                [0., 0., 1., 0.]], np.float32)
EVAL_SCALE = 2
C2I_EVAL = (np.diag([EVAL_SCALE, EVAL_SCALE, 1.0]) @ C2I).astype(np.float32)
CALIB_EVAL = {'P2': C2I_EVAL, 'P3': C2I_EVAL,
              'R0': np.eye(3, dtype=np.float32),
              'Tr_velo2cam': L2C[:3].astype(np.float32)}


def project(xyz):
    """Lidar xyz (N, 3) -> pixel (u, v) and depth."""
    cam = xyz @ L2C[:3, :3].T + L2C[:3, 3]
    d = cam[:, 2]
    u = FU * cam[:, 0] / np.clip(d, 1e-3, None) + CU
    v = FU * cam[:, 1] / np.clip(d, 1e-3, None) + CV
    return u, v, d


def zbuffer(u, v, d, h, w):
    """Nearest depth per pixel of an (h, w) grid, 0 where no point lands."""
    ui = np.floor(u).astype(np.int64)
    vi = np.floor(v).astype(np.int64)
    ok = (d > 1e-3) & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    buf = np.full(h * w, np.inf, np.float32)
    np.minimum.at(buf, vi[ok] * w + ui[ok], d[ok].astype(np.float32))
    buf[~np.isfinite(buf)] = 0.0
    return buf.reshape(h, w)


def render_scene(points, gt, gt_mask):
    """(image (H, W, 3), depth map (H / DS, W / DS), 2-D boxes (N_GT, 4) in
    image pixels)."""
    from ..utils import box_utils
    xyz = points[:, :3]
    u, v, d = project(xyz)
    depth_full = zbuffer(u, v, d, H, W)
    depth_ds = zbuffer(u / DS, v / DS, d, H // DS, W // DS)
    ui = np.floor(u).astype(np.int64)
    vi = np.floor(v).astype(np.int64)
    ok = (d > 1e-3) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    hbuf = np.full(H * W, -10.0, np.float32)
    np.maximum.at(hbuf, vi[ok] * W + ui[ok], xyz[ok, 2].astype(np.float32))
    hbuf[hbuf < -9.0] = 0.0
    image = np.stack([np.clip(depth_full / DEPTH_MAX, 0, 1),
                      (depth_full > 0).astype(np.float32),
                      np.clip((hbuf.reshape(H, W) + 3.0) / 4.0, 0, 1)],
                     axis=-1).astype(np.float32)
    boxes2d = np.zeros((ca.N_GT, 4), np.float32)
    for g in range(ca.N_GT):
        if not gt_mask[g]:
            continue
        corners = box_utils.boxes_to_corners_3d_np(gt[g:g + 1, :7])[0]
        cu_, cv_, cd = project(np.asarray(corners))
        if (cd <= 1e-3).any():
            continue
        boxes2d[g] = [np.clip(cu_.min(), 0, W - 1),
                      np.clip(cv_.min(), 0, H - 1),
                      np.clip(cu_.max(), 0, W - 1),
                      np.clip(cv_.max(), 0, H - 1)]
    return image, depth_ds, boxes2d


def make_camera_batches(scenes, device):
    """Batches of ca.BATCH rendered scenes as tensors on `device`."""
    out = []
    for bi in range(0, len(scenes), ca.BATCH):
        part = scenes[bi:bi + ca.BATCH]
        rendered = [render_scene(*s) for s in part]
        b = len(part)
        arrays = {
            'points': np.zeros((b, 1, 4), np.float32),
            'points_mask': np.zeros((b, 1), bool),
            'images': np.stack([r[0] for r in rendered]),
            'trans_lidar_to_cam': np.tile(L2C, (b, 1, 1)),
            'trans_cam_to_img': np.tile(C2I, (b, 1, 1)),
            'image_shape': np.tile(np.array([H, W], np.int32), (b, 1)),
            'gt_boxes': np.stack([s[1] for s in part]),
            'gt_mask': np.stack([s[2] for s in part]),
            'gt_uncertainty': np.ones((b, ca.N_GT, 7), np.float32),
            'depth_maps': np.stack([r[1] for r in rendered]),
            # the depth loss takes its boxes at the feature map's scale
            'gt_boxes2d': np.stack([r[2] for r in rendered]) / DS,
            'gt_boxes2d_mask': np.stack([s[2] for s in part]),
        }
        out.append({k: torch.from_numpy(v).to(device)
                    for k, v in arrays.items()})
    return out


def make_scenes():
    """convergence_ap's scenes with the gts beyond GT_MAX_X unlabelled."""
    scenes = [ca.make_scene(s) for s in range(ca.N_SCENES)]
    for _, gt, gm in scenes:
        gm &= gt[:, 0] < GT_MAX_X
    return scenes


@torch.no_grad()
def depth_accuracy(det, batch, disc):
    """Top-1 and within-one-bin accuracy of the depth bins at the pixels
    with a depth."""
    from ..models.detectors import camera_of
    from ..models.image_vfe import bin_depths
    logits = det.net(None, None, camera=camera_of(batch))['depth_logits']
    target = bin_depths(batch['depth_maps'], disc['mode'],
                        float(disc['depth_min']), float(disc['depth_max']),
                        int(disc['num_bins']), target=True)
    pred = logits.argmax(-1)
    valid = batch['depth_maps'] > 0
    n = max(int(valid.sum()), 1)
    return (int(((pred == target) & valid).sum()) / n,
            int((((pred - target).abs() <= 1) & valid).sum()) / n)


def main(argv=None):
    from ..eval import kitti_eval
    from ..utils.calibration_kitti import Calibration

    args = ca.parse_args(argv, default_yaml='configs/kitti_models/CaDDN.yaml',
                         default_steps=700, extra=())
    cfg = ca.load_cfg(args.model_yaml)
    ca.zero_score_thresholds(cfg)
    det = ca.fresh_detector(cfg, args.device)
    device = det.device

    scenes = make_scenes()
    batches = make_camera_batches(scenes, device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    state, final_loss, t0, step_ms = ca.run_overfit(det, batches,
                                                    args.n_steps,
                                                    args.peak_lr)
    top1, near = depth_accuracy(det, batches[0], cfg.MODEL.VFE.FFN.DISCRETIZE)
    print(f'[diag] depth-bin top-1 accuracy at pixels with a depth: '
          f'{top1:.3f} (within +-1 bin: {near:.3f})', flush=True)

    calib = Calibration(CALIB_EVAL)
    shape = (H * EVAL_SCALE, W * EVAL_SCALE)
    gt_annos, dt_annos = [], []
    for bi, b in enumerate(batches):
        preds = det.predict(b)
        fb, fs, fv = (preds[k].cpu().numpy() for k in
                      ('final_boxes', 'final_scores', 'final_valid'))
        if bi == 0:
            print(f'diag batch0: kept={fv.sum(1)}, '
                  f'score_max={fs.max(1).round(3)}', flush=True)
        for k in range(fb.shape[0]):
            gt, gm = scenes[bi * ca.BATCH + k][1:]
            gt_annos.append(ca.to_annos(gt[gm][:, :7], None, calib, shape))
            dt_annos.append(ca.to_annos(fb[k][fv[k]], fs[k][fv[k]], calib,
                                        shape))
    result_str, ret = kitti_eval.get_official_eval_result(
        gt_annos, dt_annos, ['Car'], device=device)
    print(result_str)
    dump = ca.dump_run('CaDDN', state, {'gt': gt_annos, 'dt': dt_annos})
    print(f'checkpoint and annos in {dump}', flush=True)
    out = {
        'model': f'{Path(args.model_yaml).stem} (full config, synthetic '
                 f'camera overfit)',
        'n_scenes': ca.N_SCENES, 'n_steps': args.n_steps,
        'final_loss': final_loss,
        'Car_3d_moderate_R40': ret.get('Car_3d/moderate_R40'),
        'Car_3d_moderate_R11': ret.get('Car_3d/moderate_R11'),
        'Car_bev_moderate_R40': ret.get('Car_bev/moderate_R40'),
        'Car_bev_moderate_R11': ret.get('Car_bev/moderate_R11'),
        'depth_top1': round(top1, 4),
        'wall_clock_s': round(time.time() - t0, 1),
        'device': ca.device_line(device),
        'ms_per_step': round(step_ms, 2),
        'peak_gib': ca.peak_gib(device),
    }
    ca.merge_entry('CaDDN', out, args.out)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
