"""Accuracy-convergence harness of the port (the counterpart of the
repository's tools/convergence_ap.py): overfit a full KITTI-scale config on
16 synthetic scenes made with numpy only, then score it with the port's
KITTI evaluator (eval/kitti_eval.py).

This closes the chain the op-level parity tests cannot: target assignment
-> losses -> proposal NMS -> RoI sampling -> pooling -> refinement -> final
NMS -> camera-frame annotations -> matched AP.  A wrong component anywhere
caps the AP a family reaches.

    python -m glenet_tpu_torch.tools.convergence_ap [n_steps] [peak_lr]
        [model_yaml] [test_voxel_budget] [n_holdout] [--device cpu]
        [--out FILE]

Defaults: 600 steps, peak LR 1e-3, configs/kitti_models/GLENet_VR.yaml.
A 4th positional clamps the config's TEST voxel budget; a 5th scores that
many unseen scenes (seeds 1000 + s) too and files the entry under
'<model>_holdout' instead of '<model>'.  The entry, with the device's name
and power limit, is merged into CONVERGENCE_AP_TORCH.json at the
repository root (or --out); the checkpoint of the run (train/checkpoint.py
format) and annos.pkl go to <tempdir>/conv_torch_<model>/.  Runs on the
GPU unless --device cpu is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import json
import pickle
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .train import synchronize

ROOT = Path(__file__).resolve().parents[2]
RESULTS = ROOT / 'CONVERGENCE_AP_TORCH.json'

N_SCENES = 16
BATCH = 2
MAX_POINTS = 20000
N_GT = 8
# the optimizer: clip, then AdamW over a cosine one-cycle (pct_start 0.3)
CLIP_NORM, WEIGHT_DECAY, PCT_START = 10.0, 0.01, 0.3
INIT_SEED = 0              # the torch seed of a fresh detector's weights

CALIB = {
    'P2': np.array([[707.05, 0., 604.08, 45.76],
                    [0., 707.05, 180.51, -0.35],
                    [0., 0., 1., 0.005]], np.float32),
    'P3': np.array([[707.05, 0., 604.08, -337.58],
                    [0., 707.05, 180.51, 2.37],
                    [0., 0., 1., 0.005]], np.float32),
    'R0': np.eye(3, dtype=np.float32),
    'Tr_velo2cam': np.array([[0., -1., 0., 0.],
                             [0., 0., -1., -0.08],
                             [1., 0., 0., -0.27]], np.float32),
}


def car_surface_points(rng, box, n=350):
    """Points on the walls and roof of a box (lidar-like surfaces).

    The shape is front/back asymmetric (a 3x denser front face, a cabin
    roof over the rear half), so the heading's direction, not only its
    axis, can be read from the geometry.
    """
    x, y, z, dx, dy, dz, ry = box
    faces = [('x+', 3.0 * dy * dz), ('x-', dy * dz), ('y+', dx * dz),
             ('y-', dx * dz), ('z+', dx * dy)]
    areas = np.array([a for _, a in faces])
    pick = rng.choice(len(faces), size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    local = np.zeros((n, 3))
    for i, (name, _) in enumerate(faces):
        m = pick == i
        if name[0] == 'x':
            local[m] = np.stack([np.full(m.sum(), 0.5 if name == 'x+'
                                         else -0.5) * dx,
                                 u[m] * dy, v[m] * dz], 1)
        elif name[0] == 'y':
            local[m] = np.stack([u[m] * dx,
                                 np.full(m.sum(), 0.5 if name == 'y+'
                                         else -0.5) * dy, v[m] * dz], 1)
        else:
            # cabin roof: half-length, centred over the rear half
            local[m] = np.stack([(0.5 * u[m] - 0.2) * dx, v[m] * dy,
                                 np.full(m.sum(), 0.5) * dz], 1)
    c, s = np.cos(ry), np.sin(ry)
    gx = local[:, 0] * c - local[:, 1] * s + x
    gy = local[:, 0] * s + local[:, 1] * c + y
    gz = local[:, 2] + z
    return np.stack([gx, gy, gz], 1)


def make_scene(seed):
    """-> (points (MAX_POINTS, 4) f32, gt (N_GT, 8) f32, gt_mask (N_GT,)):
    3-7 cars in the camera's field of view on a flat ground."""
    rng = np.random.RandomState(seed)
    n_cars = rng.randint(3, N_GT)
    gt = np.zeros((N_GT, 8), np.float32)
    gt_mask = np.zeros(N_GT, bool)
    placed = []
    for g in range(n_cars):
        for _ in range(20):
            cx = rng.uniform(8, 55)
            # inside the synthetic camera's ~41 degree half-angle: KITTI
            # labels only objects in the field of view
            ymax = min(18.0, 0.7 * cx)
            cy = rng.uniform(-ymax, ymax)
            if all((cx - px) ** 2 + (cy - py) ** 2 > 36 for px, py in placed):
                break
        placed.append((cx, cy))     # the last candidate even if crowded
        dims = [rng.uniform(3.6, 4.3), rng.uniform(1.5, 1.8),
                rng.uniform(1.4, 1.7)]
        gt[g] = [placed[-1][0], placed[-1][1], -1.0 + dims[2] / 2 - 0.8,
                 *dims, rng.uniform(-np.pi, np.pi), 1]
        gt_mask[g] = True

    pts = [car_surface_points(rng, gt[g, :7]) for g in range(n_cars)]
    n_ground = MAX_POINTS - sum(len(p) for p in pts)
    ground = np.stack([rng.uniform(0, 69, n_ground),
                       rng.uniform(-39, 39, n_ground),
                       rng.normal(-1.8, 0.05, n_ground)], 1)
    xyz = np.concatenate(pts + [ground])[:MAX_POINTS]
    intens = np.random.RandomState(seed + 1).uniform(0, 1, (len(xyz), 1))
    return np.concatenate([xyz, intens], 1).astype(np.float32), gt, gt_mask


def to_annos(boxes_lidar, scores, calib, image_shape=(375, 1242)):
    """Lidar boxes (N, 7) -> a KITTI annotation dict of Cars (with 'score'
    when `scores` is given)."""
    from ..utils import box_utils
    if len(boxes_lidar) == 0:
        return {'name': np.array([]), 'bbox': np.zeros((0, 4)),
                'location': np.zeros((0, 3)), 'dimensions': np.zeros((0, 3)),
                'rotation_y': np.zeros(0), 'alpha': np.zeros(0),
                'occluded': np.zeros(0), 'truncated': np.zeros(0),
                **({'score': np.zeros(0)} if scores is not None else {})}
    cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes_lidar, calib)
    img = box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib,
                                                       image_shape)
    alpha = -np.arctan2(-boxes_lidar[:, 1], boxes_lidar[:, 0]) + cam[:, 6]
    anno = {'name': np.array(['Car'] * len(cam)), 'bbox': img,
            'location': cam[:, 0:3], 'dimensions': cam[:, 3:6],
            'rotation_y': cam[:, 6], 'alpha': alpha,
            'occluded': np.zeros(len(cam)), 'truncated': np.zeros(len(cam))}
    if scores is not None:
        anno['score'] = scores
    return anno


def make_batches(scenes, batch_size, max_points, n_gt, device):
    """Padded batches of (points, gt, gt_mask) scenes as tensors on
    `device`: every point valid, label variances 0.05."""

    def batch_of(idxs):
        pts = np.stack([scenes[i][0] for i in idxs])
        gt = np.stack([scenes[i][1] for i in idxs])
        gm = np.stack([scenes[i][2] for i in idxs])
        return {
            'points': torch.from_numpy(pts).to(device),
            'points_mask': torch.ones((len(idxs), max_points),
                                      dtype=torch.bool, device=device),
            'gt_boxes': torch.from_numpy(gt).to(device),
            'gt_mask': torch.from_numpy(gm).to(device),
            'gt_uncertainty': torch.full((len(idxs), n_gt, 7), 0.05,
                                         dtype=torch.float32, device=device),
        }

    return [batch_of(list(range(i, i + batch_size)))
            for i in range(0, len(scenes), batch_size)]


def harness_optimizer(n_steps, peak_lr):
    """Clip at 10, then AdamW (decay 0.01 on every parameter) over optax's
    cosine one-cycle, its length clamped to 4 steps at least (shorter
    phases would be empty)."""
    from ..train.optim import Adam, cosine_onecycle_schedule
    return Adam(cosine_onecycle_schedule(max(n_steps, 4), peak_lr,
                                         pct_start=PCT_START),
                WEIGHT_DECAY, CLIP_NORM)


def fresh_detector(cfg, device, seed=INIT_SEED):
    """The config's detector with the weights torch draws from `seed`."""
    from ..models.detectors import build_detector
    torch.manual_seed(seed)
    return build_detector(cfg, device=device)


def _terms(metrics):
    return ' '.join(f'{k}={float(v):.3f}' for k, v in sorted(metrics.items())
                    if k != 'grad_norm')


def run_overfit(det, batches, n_steps, peak_lr, bn_frozen_tail=0):
    """One-cycle overfit loop shared by the KITTI and Waymo harnesses; the
    detector's weights and BN stats change in place.  Returns (the train
    state of the one-cycle run, the last printed loss, the loop's start
    time, the mean ms of its one-cycle steps).

    After the loop the BN running stats are re-estimated exactly over the
    batches.  bn_frozen_tail > 0 then fine-tunes for that many steps at a
    constant 0.1 x peak_lr with every BN normalising with those (frozen)
    stats in train mode too, so training and predict normalise alike.
    """
    from ..models import layers
    from ..train.bn_refresh import refresh_detector_stats
    from ..train.optim import Adam
    from ..train.state import TrainState, create_train_state, make_train_step

    tx = harness_optimizer(n_steps, peak_lr)
    state = create_train_state(det, tx)
    train_step = make_train_step(det, tx)
    t0 = time.time()
    final_loss = float('nan')
    for i in range(n_steps):
        state, metrics = train_step(state, batches[i % len(batches)])
        if i % 50 == 0 or i == n_steps - 1:
            final_loss = float(metrics['loss'])
            print(f'step {i}: loss={final_loss:.3f} '
                  f'({time.time() - t0:.0f}s) | {_terms(metrics)}',
                  flush=True)
    synchronize(det.device)
    step_ms = 1e3 * (time.time() - t0) / max(n_steps, 1)
    print(f'{n_steps} steps: {step_ms:.1f} ms per step', flush=True)

    # a short run leaves the BN EMA (momentum 0.01) several time constants
    # short of the activation moments: re-estimate them exactly
    refresh_detector_stats(det, batches)
    print(f'bn stats refreshed over {len(batches)} batches', flush=True)

    if bn_frozen_tail > 0:
        layers.BN_FORCE_RUNNING_STATS = True
        try:
            tx2 = Adam(0.1 * peak_lr, WEIGHT_DECAY, CLIP_NORM)
            tail = TrainState(step=10_000, net=det.net,
                              opt_state=tx2.init(list(det.net.parameters())))
            tail_step = make_train_step(det, tx2)
            for i in range(bn_frozen_tail):
                tail, metrics = tail_step(tail, batches[i % len(batches)])
                if i % 50 == 0 or i == bn_frozen_tail - 1:
                    final_loss = float(metrics['loss'])
                    print(f'frozen-bn step {i}: loss={final_loss:.3f} '
                          f'({time.time() - t0:.0f}s)', flush=True)
        finally:
            layers.BN_FORCE_RUNNING_STATS = False
        # the frozen steps left the stats alone, and the parameters are now
        # adapted to the stats predict uses: no second refresh
    return state, final_loss, t0, step_ms


def device_line(device):
    """The card's name and power limit as nvidia-smi prints them, or
    'cpu'."""
    if device.type != 'cuda':
        return 'cpu'
    from ..utils.cuda_timing import card_line
    return card_line()


def peak_gib(device):
    if device.type != 'cuda':
        return None
    return round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)


def merge_entry(model_key, out, path=RESULTS):
    """Merge one model's result into the port's results file."""
    path = Path(path)
    try:
        merged = json.loads(path.read_text())
    except (FileNotFoundError, ValueError):
        merged = {}
    merged[model_key] = out
    path.write_text(json.dumps(merged, indent=1) + '\n')


def dump_run(model_key, state, annos):
    """The run's checkpoint and annotations -> <tempdir>/conv_torch_<key>/;
    returns the directory."""
    from ..train.checkpoint import checkpoint_state, save_checkpoint
    dump = Path(tempfile.gettempdir()) / f'conv_torch_{model_key}'
    dump.mkdir(parents=True, exist_ok=True)
    save_checkpoint(checkpoint_state(state, epoch=1, it=state.step), dump,
                    epoch=1, max_ckpt_save_num=1)
    with open(dump / 'annos.pkl', 'wb') as f:
        pickle.dump(annos, f)
    return dump


def kitti_annos(det, scenes, batches, calib, diag=True):
    """Predicts over `batches` -> (gt annos, dt annos) of `scenes`; prints
    the first batch's kept counts, top scores and first box."""
    gt_annos, dt_annos = [], []
    for bi, b in enumerate(batches):
        preds = det.predict(b)
        fb, fs, fv = (preds[k].cpu().numpy() for k in
                      ('final_boxes', 'final_scores', 'final_valid'))
        if bi == 0 and diag:
            print(f'diag batch0: kept={fv.sum(1)}, '
                  f'score_max={fs.max(1).round(3)}, '
                  f'box0={fb[0, 0].round(2) if fv[0].any() else None}',
                  flush=True)
        for k in range(fb.shape[0]):
            gt, gm = scenes[bi * BATCH + k][1], scenes[bi * BATCH + k][2]
            gt_annos.append(to_annos(gt[gm][:, :7], None, calib))
            dt_annos.append(to_annos(fb[k][fv[k]], fs[k][fv[k]], calib))
    return gt_annos, dt_annos


def zero_score_thresholds(cfg):
    """AP is rank-based, and the published score gates assume an 80-epoch
    confidence scale: keep the ranking, drop the gates."""
    post = cfg.MODEL.POST_PROCESSING
    post.POST_SCORE_THRESH = 0.0
    post.SCORE_THRESH = 0.0


def clamp_test_budget(cfg, budget):
    """MAX_NUMBER_OF_VOXELS['test'] = budget (the train budget stays)."""
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'transform_points_to_voxels':
            mv = proc.MAX_NUMBER_OF_VOXELS
            if isinstance(mv, dict):
                mv['test'] = int(budget)


def parse_args(argv=None, default_yaml='configs/kitti_models/GLENet_VR.yaml',
               default_steps=600, extra=('test_voxel_budget', 'n_holdout')):
    parser = argparse.ArgumentParser()
    parser.add_argument('n_steps', nargs='?', type=int, default=default_steps)
    parser.add_argument('peak_lr', nargs='?', type=float, default=1e-3)
    parser.add_argument('model_yaml', nargs='?', default=default_yaml)
    for name in extra:
        parser.add_argument(name, nargs='?', type=int, default=None)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--out', default=str(RESULTS),
                        help='the results file to merge the entry into')
    return parser.parse_args(argv)


def load_cfg(model_yaml):
    from ..config import cfg_from_yaml_file
    path = Path(model_yaml)
    return cfg_from_yaml_file(str(path if path.is_absolute()
                                  else ROOT / path))


def main(argv=None):
    from ..eval import kitti_eval
    from ..utils.calibration_kitti import Calibration

    args = parse_args(argv)
    cfg = load_cfg(args.model_yaml)
    if args.test_voxel_budget is not None:
        clamp_test_budget(cfg, args.test_voxel_budget)
    zero_score_thresholds(cfg)
    det = fresh_detector(cfg, args.device)
    device = det.device
    n_holdout = args.n_holdout or 0

    scenes = [make_scene(s) for s in range(N_SCENES)]
    batches = make_batches(scenes, BATCH, MAX_POINTS, N_GT, device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    state, final_loss, t0, step_ms = run_overfit(det, batches, args.n_steps,
                                                 args.peak_lr)

    # ---- the training scenes (the overfit target: AP -> 100) ------------
    calib = Calibration(CALIB)
    gt_annos, dt_annos = kitti_annos(det, scenes, batches, calib)
    result_str, ret = kitti_eval.get_official_eval_result(
        gt_annos, dt_annos, ['Car'], device=device)
    print(result_str)
    model_key = Path(args.model_yaml).stem

    ret_val = None
    if n_holdout > 0:
        # unseen scenes: generator seeds disjoint from 0..N_SCENES-1
        val_scenes = [make_scene(1000 + s) for s in range(n_holdout)]
        val_batches = make_batches(val_scenes, BATCH, MAX_POINTS, N_GT,
                                   device)
        gt_v, dt_v = kitti_annos(det, val_scenes, val_batches, calib)
        val_str, ret_val = kitti_eval.get_official_eval_result(
            gt_v, dt_v, ['Car'], device=device)
        print('=== HELD-OUT (unseen scenes) ===')
        print(val_str)

    dump = dump_run(model_key, state, {
        'gt': gt_annos, 'dt': dt_annos,
        'scenes_gt': [(s[1], s[2]) for s in scenes]})
    print(f'checkpoint and annos in {dump}', flush=True)
    out = {
        'model': f'{model_key} (full config, synthetic overfit)',
        'n_scenes': N_SCENES, 'n_steps': args.n_steps,
        'final_loss': final_loss,
        'Car_3d_moderate_R40': ret.get('Car_3d/moderate_R40'),
        'Car_3d_moderate_R11': ret.get('Car_3d/moderate_R11'),
        'Car_bev_moderate_R40': ret.get('Car_bev/moderate_R40'),
        'wall_clock_s': round(time.time() - t0, 1),
        'device': device_line(device),
        'ms_per_step': round(step_ms, 2),
        'peak_gib': peak_gib(device),
    }
    if ret_val is not None:
        out['n_holdout_scenes'] = n_holdout
        out['val_Car_3d_moderate_R40'] = ret_val.get('Car_3d/moderate_R40')
        out['val_Car_bev_moderate_R40'] = ret_val.get('Car_bev/moderate_R40')
    merge_entry(model_key + ('_holdout' if ret_val is not None else ''), out,
                args.out)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
