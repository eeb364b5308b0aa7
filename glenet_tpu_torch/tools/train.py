"""Training CLI of the port, the counterpart of the repository's
tools/train.py:

    python -m glenet_tpu_torch.tools.train --cfg_file CFG [--device cpu] ...

Config and overrides, dataset, detector and optimizer, auto-resume from the
newest checkpoint in <output_dir>/ckpt (the port's `.pth`, or when there
is none a glenet_tpu `.msgpack`; --ckpt takes either: a `.msgpack` brings
its parameters, BN statistics, optimizer state and step, and the run goes
on writing `.pth`), the epoch loop with per-step
telemetry (data ms: `iter_batches` until the batch is on the device; step
ms: the train step until its results are on the host), a checkpoint per
epoch (pruned to --max_ckpt_save_num), then optionally the BN-statistics
refresh and an evaluation of the final model.  Runs on the GPU unless
--device cpu is given; without a GPU it raises.  One process on one device:
the multi-host flags and data-loading workers raise NotImplementedError.

`main(argv)` returns the run's record: the step it started from, one dict
per step (epoch, it, data_ms, step_ms, every loss term, grad_norm, lr), the
checkpoints written, the trained detector and, with --eval_after_train,
the evaluation.
"""
from __future__ import annotations

import argparse
import itertools
import time
from pathlib import Path

import numpy as np
import torch

MULTI_HOST_FLAGS = ('coordinator_address', 'num_processes', 'process_id')


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--max_ckpt_save_num', type=int, default=30)
    parser.add_argument('--workers', type=int, default=0)
    parser.add_argument('--set', dest='set_cfgs', nargs=argparse.REMAINDER,
                        default=None)
    parser.add_argument('--data_path', type=str, default=None)
    parser.add_argument('--output_dir', type=str, default=None)
    parser.add_argument('--eval_after_train', action='store_true')
    parser.add_argument('--bn_refresh', type=int, default=0,
                        help='re-estimate the BN running stats over N '
                             'batches after training (exact pooled moments)')
    parser.add_argument('--max_steps_per_epoch', type=int, default=None)
    parser.add_argument('--profile_steps', type=int, default=0,
                        help='write a torch.profiler trace of N train steps '
                             'to <output_dir>/profile')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--coordinator_address', type=str, default=None)
    parser.add_argument('--num_processes', type=int, default=None)
    parser.add_argument('--process_id', type=int, default=None)
    args = parser.parse_args(argv)
    for flag in MULTI_HOST_FLAGS:
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f'--{flag}: multi-host training is not ported yet')
    if args.workers:
        raise NotImplementedError(
            '--workers: data-loading worker processes are not ported yet')

    from ..config import cfg_from_list, cfg_from_yaml_file
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    if args.data_path is not None:
        cfg.DATA_CONFIG.DATA_PATH = args.data_path
    return args, cfg


def to_device(batch, device):
    """The array fields of a collated batch as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def synchronize(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _start_profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def main(argv=None):
    args, cfg = parse_config(argv)
    from ..utils.common import resolve_device
    device = resolve_device(args.device)

    from ..datasets import build_dataset
    from ..models.detectors import build_detector
    from ..train import checkpoint as ckpt_lib
    from ..train import jax_checkpoint
    from ..train import optim as optim_lib
    from ..train import state as state_lib
    from ..utils.common import create_logger
    from ..utils.summary import ScalarWriter

    output_dir = Path(args.output_dir or f'output/{cfg.TAG}/{args.extra_tag}')
    ckpt_dir = output_dir / 'ckpt'
    latest = (args.ckpt or ckpt_lib.find_latest_checkpoint(ckpt_dir)
              or ckpt_lib.find_latest_checkpoint(ckpt_dir,
                                                 jax_checkpoint.PATTERN))
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(output_dir / 'train.log')

    batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    num_epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)
    dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True,
                            logger=logger, seed=0)
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    total_steps = steps_per_epoch * num_epochs

    detector = build_detector(cfg, device=device)
    tx, lr_sched = optim_lib.build_optimizer(cfg.OPTIMIZATION, total_steps)
    # the JAX CLI draws an example batch to initialise its train state;
    # drawing it here too keeps the dataset's and the augmentor's random
    # streams in step with it
    next(dataset.iter_batches(batch_size, seed=0))
    ts = state_lib.create_train_state(detector, tx)
    train_step = state_lib.make_train_step(detector, tx)
    logger.info(f'device {device}, batch {batch_size}, {steps_per_epoch} '
                f'steps/epoch, {num_epochs} epochs')

    start_epoch = 0
    if latest:
        logger.info(f'resuming from {latest}')
        if str(latest).endswith('.msgpack'):
            ck = jax_checkpoint.load_checkpoint(latest)
            jax_checkpoint.restore_train_state(ts, ck, tx)
        else:
            ck = ckpt_lib.load_checkpoint(latest)
            ckpt_lib.restore_train_state(ts, ck)
        start_epoch = int(ck['epoch']) + 1

    writer = ScalarWriter(output_dir / 'tensorboard')
    it = ts.step
    run = {'start_step': it, 'steps': [], 'checkpoints': [],
           'detector': detector}
    prof = None
    for epoch in range(start_epoch, num_epochs):
        t_epoch = time.perf_counter()
        batches = dataset.iter_batches(batch_size, seed=epoch)
        for step_i in range(steps_per_epoch):
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            batch = to_device(batch, device)
            synchronize(device)
            t1 = time.perf_counter()
            # trace window (skips the first step)
            if args.profile_steps and it == 1 and prof is None:
                prof = _start_profiler(device)
            lr = lr_sched(it)
            ts, metrics = train_step(ts, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            t2 = time.perf_counter()
            it += 1
            if prof is not None and it > args.profile_steps:
                synchronize(device)
                prof.stop()
                (output_dir / 'profile').mkdir(exist_ok=True)
                prof.export_chrome_trace(
                    str(output_dir / 'profile' / 'trace.json'))
                prof = None
                logger.info(f'torch.profiler trace -> {output_dir}/profile')
            rec = {'epoch': epoch, 'it': it, 'data_ms': 1e3 * (t1 - t0),
                   'step_ms': 1e3 * (t2 - t1), 'lr': lr, **metrics}
            run['steps'].append(rec)
            if step_i % 50 == 0:
                logger.info(
                    f'epoch {epoch} it {it} loss {metrics["loss"]:.4f} '
                    f'lr {lr:.6f} grad {metrics["grad_norm"]:.2f} '
                    f'data {rec["data_ms"]:.1f} ms step '
                    f'{rec["step_ms"]:.1f} ms')
                writer.add_scalars(
                    {f'train/{k}': v for k, v in metrics.items()}
                    | {'meta_data/learning_rate': lr,
                       'meta_data/data_ms': rec['data_ms'],
                       'meta_data/step_ms': rec['step_ms']}, it)
        logger.info(f'epoch {epoch} done in '
                    f'{time.perf_counter() - t_epoch:.1f}s')
        run['checkpoints'].append(ckpt_lib.save_checkpoint(
            ckpt_lib.checkpoint_state(ts, epoch, it), ckpt_dir, epoch,
            args.max_ckpt_save_num))
    writer.close()

    if args.bn_refresh:
        from ..train.bn_refresh import refresh_detector_stats
        refresh = [to_device(b, device) for b in itertools.islice(
            dataset.iter_batches(batch_size, seed=num_epochs),
            args.bn_refresh)]
        refresh_detector_stats(detector, refresh)
        run['checkpoints'].append(ckpt_lib.save_checkpoint(
            ckpt_lib.checkpoint_state(ts, num_epochs - 1, it), ckpt_dir,
            num_epochs - 1, args.max_ckpt_save_num))
        logger.info(f'BN stats refreshed over {len(refresh)} batches')
    if args.eval_after_train:
        from .test import eval_checkpoint
        run['eval'] = eval_checkpoint(cfg, detector, output_dir, logger,
                                      batch_size=batch_size)
    return run


if __name__ == '__main__':
    main()
