"""Evaluation CLI of the port, the counterpart of the repository's
tools/test.py:

    python -m glenet_tpu_torch.tools.test --cfg_file CFG [--ckpt PATH]
        [--eval_all] [--device cpu] ...

Evaluates one checkpoint (--ckpt, else the newest in --ckpt_dir or
<output_dir>/ckpt; --ckpt also takes a glenet_tpu `.msgpack`, whose
parameters and BN statistics train/jax_checkpoint.py reads, and
tools.convert_weights turns a reference `.pth` into a port checkpoint) or,
with --eval_all, every checkpoint of the directory
as it appears (polling every 30 s, at most --max_waiting_mins without a new
one).  Per checkpoint: batched predicts on the device, prediction dicts,
recall telemetry (3D IoU on the device), `result.pkl` and the dataset's
evaluation: the KITTI AP (overlaps and matcher on the device) or, for a
Waymo config, Waymo's AP / APH at LEVEL_1 / LEVEL_2 (IoUs on the
device, matching on the host).  Runs on the GPU unless --device cpu
is given; without a GPU it raises.

`main(argv)` returns {checkpoint path: eval_one_epoch's result}.
"""
from __future__ import annotations

import argparse
import glob
import pickle
import time
from pathlib import Path

from .train import to_device


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--ckpt_dir', type=str, default=None)
    parser.add_argument('--eval_all', action='store_true')
    parser.add_argument('--max_waiting_mins', type=int, default=30)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--data_path', type=str, default=None)
    parser.add_argument('--output_dir', type=str, default=None)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--set', dest='set_cfgs', nargs=argparse.REMAINDER,
                        default=None)
    args = parser.parse_args(argv)
    from ..config import cfg_from_list, cfg_from_yaml_file
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    if args.data_path is not None:
        cfg.DATA_CONFIG.DATA_PATH = args.data_path
    return args, cfg


def eval_one_epoch(cfg, detector, dataset, logger, batch_size=4,
                   result_dir=None):
    """Batched predicts -> prediction dicts -> the dataset's evaluation
    (KITTI AP, or Waymo AP / APH), with the recall of the gt boxes at
    RECALL_THRESH_LIST.  Returns {'ap': ret_dict, 'result_str', 'frames',
    'sec_per_frame' (predicts and prediction dicts, per frame), 'eval_sec'
    (the evaluation alone), 'recall'}."""
    import torch

    from ..ops import iou3d
    from ..utils.summary import ScalarWriter
    recall_thresh = list(cfg.MODEL.POST_PROCESSING.get(
        'RECALL_THRESH_LIST', [0.3, 0.5, 0.7]))
    recall = {t: 0 for t in recall_thresh}
    total_gt = 0

    det_annos = []
    t0 = time.perf_counter()
    n_frames = 0
    for batch in dataset.iter_batches(batch_size, shuffle=False,
                                      drop_last=False):
        arrays = to_device(batch, detector.device)
        preds = detector.predict(arrays)
        # wrap-padded tail: only keep real frames
        n_real = min(batch_size, len(dataset) - n_frames)
        det_annos.extend(
            dataset.generate_prediction_dicts(batch, preds)[:n_real])

        for b in range(n_real):
            gt = arrays['gt_boxes'][b][arrays['gt_mask'][b]][:, :7]
            boxes = preds['final_boxes'][b][preds['final_valid'][b]]
            total_gt += len(gt)
            if len(gt) == 0 or len(boxes) == 0:
                continue
            best = iou3d.boxes_iou3d(gt, boxes).amax(dim=1)
            for t in recall_thresh:
                recall[t] += int((best > t).sum())

        n_frames += n_real
        if n_frames >= len(dataset):
            break
    sec_per_frame = (time.perf_counter() - t0) / max(len(dataset), 1)
    rates = {t: recall[t] / max(total_gt, 1) for t in recall_thresh}
    for t in recall_thresh:
        logger.info(f'recall@{t}: {rates[t]:.4f} ({recall[t]}/{total_gt})')
    logger.info(f'eval: {len(det_annos)} frames, {sec_per_frame:.4f} s/frame '
                f'({1.0 / max(sec_per_frame, 1e-9):.1f} scans/s)')
    if result_dir is not None:
        result_dir.mkdir(parents=True, exist_ok=True)
        with open(result_dir / 'result.pkl', 'wb') as f:
            pickle.dump(det_annos, f)
    t_eval = time.perf_counter()
    result_str, ret_dict = dataset.evaluation(det_annos, cfg.CLASS_NAMES,
                                              device=detector.device)
    if detector.device.type == 'cuda':
        torch.cuda.synchronize(detector.device)
    eval_sec = time.perf_counter() - t_eval
    logger.info('\n' + result_str)
    logger.info(f'{dataset.METRIC} evaluation: {eval_sec:.3f} s')
    if result_dir is not None:
        writer = ScalarWriter(Path(result_dir) / 'tensorboard')
        writer.add_scalars({f'eval/{k}': v for k, v in ret_dict.items()
                            if isinstance(v, (int, float))}, 0)
        writer.add_scalars({f'eval/recall_{t}': r for t, r in rates.items()},
                           0)
        writer.close()
    return {'ap': ret_dict, 'result_str': result_str,
            'frames': len(det_annos), 'sec_per_frame': sec_per_frame,
            'eval_sec': eval_sec, 'recall': rates}


def eval_checkpoint(cfg, detector, output_dir, logger, batch_size=4):
    """Evaluate `detector` as it stands on the test split."""
    from ..datasets import build_dataset
    dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False,
                            logger=logger)
    return eval_one_epoch(cfg, detector, dataset, logger,
                          batch_size=batch_size,
                          result_dir=Path(output_dir) / 'eval')


def main(argv=None):
    args, cfg = parse_config(argv)
    from ..utils.common import resolve_device
    device = resolve_device(args.device)

    from ..datasets import build_dataset
    from ..models.detectors import build_detector
    from ..train import checkpoint as ckpt_lib
    from ..train import jax_checkpoint
    from ..utils.common import create_logger

    output_dir = Path(args.output_dir or f'output/{cfg.TAG}/{args.extra_tag}')
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(output_dir / 'test.log')
    batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)

    detector = build_detector(cfg, device=device)
    dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False,
                            logger=logger)
    # the JAX CLI draws an example batch to initialise its train state;
    # drawing it here too keeps the dataset's subsampling draws in step
    next(dataset.iter_batches(batch_size, shuffle=False, drop_last=False))

    def run_one(ckpt_path):
        if str(ckpt_path).endswith('.msgpack'):
            ck = jax_checkpoint.load_checkpoint(ckpt_path)
            jax_checkpoint.load_variables(detector.net, ck)
        else:
            ck = ckpt_lib.load_checkpoint(ckpt_path)
            detector.net.load_state_dict(ck['model_state'])
        logger.info(f'evaluating {ckpt_path} (epoch {ck["epoch"]})')
        return eval_one_epoch(
            cfg, detector, dataset, logger, batch_size,
            result_dir=output_dir / 'eval' / f"epoch_{ck['epoch']}")

    ckpt_dir = Path(args.ckpt_dir or output_dir / 'ckpt')
    if not args.eval_all:
        ckpt = args.ckpt or ckpt_lib.find_latest_checkpoint(ckpt_dir)
        if not ckpt:
            raise FileNotFoundError(f'no checkpoint in {ckpt_dir}')
        return {ckpt: run_one(ckpt)}

    # watch loop: evaluate each new checkpoint once
    record = output_dir / 'eval' / 'eval_list_val.txt'
    record.parent.mkdir(parents=True, exist_ok=True)
    evaluated = set(record.read_text().split()) if record.exists() else set()
    results = {}
    wait_start = time.time()
    while True:
        ckpts = sorted(glob.glob(str(ckpt_dir / ckpt_lib.PATTERN)))
        todo = [c for c in ckpts if c not in evaluated]
        if not todo:
            if time.time() - wait_start > args.max_waiting_mins * 60:
                break
            time.sleep(30)
            continue
        wait_start = time.time()
        for c in todo:
            results[c] = run_one(c)
            evaluated.add(c)
            with open(record, 'a') as f:
                print(c, file=f)
    return results


if __name__ == '__main__':
    main()
