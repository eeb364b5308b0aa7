"""Demo CLI of the port, the counterpart of the repository's tools/demo.py:
run a detector over a folder of KITTI-format .bin point clouds (or, with
--ext .npy, frames in Waymo's processed layout) and print or dump its
detections.

    python -m glenet_tpu_torch.tools.demo --cfg_file CFG --data_path DIR
        [--ckpt PATH] [--ext .bin] [--output dets.jsonl]
        [--html_dir DIR] [--ply_dir DIR] [--device cpu]

Each scan (4 features per point; a Waymo frame's 5, as the Waymo dataset
reads them) is cut to its first MAX_POINTS_PER_SCENE
points (65536 when the config has none) and zero-padded to that many, as
the JAX CLI does.  --ckpt takes a port checkpoint (.pth) or a glenet_tpu
`.msgpack` (train/jax_checkpoint.py); without one the weights are the
model's random initialisation.  Per scan one JSON line {frame,
boxes_lidar, scores, labels (class names)} of the valid detections goes to
--output; --html_dir and --ply_dir export the scene the model saw
(utils/scene_vis.py).  Runs on the GPU unless --device cpu is given;
without a GPU it raises.  A camera config (CaDDN) raises by name: its
input is an image, which a .bin scan does not carry.

`main(argv)` returns the records.
"""
from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

import numpy as np


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--data_path', type=str, required=True,
                        help='folder of KITTI-format .bin files (or one file)')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--ext', type=str, default='.bin')
    parser.add_argument('--output', type=str, default=None,
                        help='write detections as JSON lines here')
    parser.add_argument('--html_dir', type=str, default=None,
                        help='export interactive 3D HTML scenes here')
    parser.add_argument('--ply_dir', type=str, default=None,
                        help='export PLY point clouds + box wireframes here')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    from ..config import cfg_from_yaml_file
    return args, cfg_from_yaml_file(args.cfg_file)


def load_scan(path, max_points, device, n_features=4):
    """A .bin scan (or a Waymo .npy frame) -> {'points' (1, max_points,
    n_features), 'points_mask'} on `device`: its first max_points points,
    zero-padded."""
    import torch
    if str(path).endswith('.npy'):
        from ..datasets.waymo_dataset import frame_points
        pts = frame_points(np.load(path)).astype(np.float32)
    else:
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    if pts.shape[1] != n_features:
        raise ValueError(f'{path}: {pts.shape[1]} features per point, the '
                         f'model takes {n_features}')
    n = min(len(pts), max_points)
    out = np.zeros((1, max_points, n_features), np.float32)
    out[0, :n] = pts[:n]
    mask = np.zeros((1, max_points), bool)
    mask[0, :n] = True
    return {'points': torch.from_numpy(out).to(device),
            'points_mask': torch.from_numpy(mask).to(device)}


def main(argv=None):
    args, cfg = parse_config(argv)
    if cfg.MODEL.get('VFE', {}).get('NAME') == 'ImageVFE':
        raise NotImplementedError(
            f'the demo runs on point clouds: {cfg.MODEL.NAME} (ImageVFE) '
            f'takes camera images, which a {args.ext} scan does not carry')
    from ..utils.common import resolve_device
    device = resolve_device(args.device)

    from ..models.detectors import build_detector
    from ..train import checkpoint as ckpt_lib
    from ..train import jax_checkpoint
    from ..utils.common import create_logger
    logger = create_logger()
    det = build_detector(cfg, device=device)

    data_path = Path(args.data_path)
    files = sorted(glob.glob(str(data_path / f'*{args.ext}'))) \
        if data_path.is_dir() else [str(data_path)]
    if not files:
        raise FileNotFoundError(f'no {args.ext} files under {args.data_path}')
    if args.ckpt:
        if args.ckpt.endswith('.msgpack'):
            jax_checkpoint.load_variables(
                det.net, jax_checkpoint.load_checkpoint(args.ckpt))
        else:
            det.net.load_state_dict(
                ckpt_lib.load_checkpoint(args.ckpt)['model_state'])
        logger.info(f'loaded {args.ckpt}')

    max_pts = int(cfg.DATA_CONFIG.get('MAX_POINTS_PER_SCENE', 65536))
    records = []
    sink = open(args.output, 'w') if args.output else None
    try:
        for f in files:
            batch = load_scan(f, max_pts, device, det.num_point_features)
            preds = {k: v[0].cpu().numpy()
                     for k, v in det.predict(batch).items()}
            v = preds['final_valid']
            record = {
                'frame': Path(f).stem,
                'boxes_lidar': preds['final_boxes'][v].tolist(),
                'scores': preds['final_scores'][v].tolist(),
                'labels': [cfg.CLASS_NAMES[int(lab) - 1]
                           for lab in preds['final_labels'][v]],
            }
            records.append(record)
            logger.info(f"{record['frame']}: {int(v.sum())} detections")
            if sink:
                print(json.dumps(record), file=sink)
            if args.html_dir or args.ply_dir:
                export_scene(args, cfg, batch, record,
                             preds['final_labels'][v])
    finally:
        if sink:
            sink.close()
    return records


def export_scene(args, cfg, batch, record, labels):
    """The scan as the model saw it (cut and padded), with the record's
    boxes, as HTML and / or PLY."""
    from ..utils import scene_vis
    raw = batch['points'][0][batch['points_mask'][0]].cpu().numpy()
    boxes = np.asarray(record['boxes_lidar'], np.float32).reshape(-1, 7)
    scores = np.asarray(record['scores'], np.float32)
    if args.html_dir:
        Path(args.html_dir).mkdir(parents=True, exist_ok=True)
        scene_vis.export_scene_html(
            raw, Path(args.html_dir) / f"{record['frame']}.html",
            ref_boxes=boxes, ref_scores=scores, ref_labels=labels,
            class_names=list(cfg.CLASS_NAMES))
    if args.ply_dir:
        Path(args.ply_dir).mkdir(parents=True, exist_ok=True)
        scene_vis.export_ply(raw, Path(args.ply_dir) / f"{record['frame']}.ply",
                             ref_boxes=boxes)


if __name__ == '__main__':
    main()
