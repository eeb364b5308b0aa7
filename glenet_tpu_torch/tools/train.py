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
--device cpu is given; without a GPU it raises.

Across processes (one per GPU, each started with the same flags):
    --coordinator_address HOST:PORT --num_processes N --process_id R
start torch.distributed (NCCL on the GPU, gloo with --device cpu; the
rendezvous raises after --dist_timeout seconds without every peer), rank R
on cuda:R % device_count.  Each rank reads every N-th frame of the epoch's
order (`iter_batches` striding) at --batch_size per rank, and
parallel/mesh.py's data-parallel step makes one step of the N x
batch_size global batch; the start state is broadcast from rank 0.  Rank 0
alone writes checkpoints and tensorboard scalars, each rank its own
train_rank<R>.log; the BN refresh and --eval_after_train run on every rank
(the evaluation strided, its results merged).  Data-loading worker
processes (--workers) raise NotImplementedError.

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

from ..parallel.distributed import DEFAULT_TIMEOUT_S


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
    parser.add_argument('--dist_timeout', type=int,
                        default=DEFAULT_TIMEOUT_S,
                        help='seconds the rendezvous and each collective '
                             'may wait for the other processes')
    args = parser.parse_args(argv)
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
    from ..parallel import distributed
    from ..utils.common import resolve_device
    device = distributed.initialize(
        args.coordinator_address, args.num_processes, args.process_id,
        resolve_device(args.device), timeout_s=args.dist_timeout)
    rank, world = distributed.get_dist_info()

    from ..datasets import build_dataset
    from ..models.detectors import build_detector
    from ..parallel import mesh as mesh_lib
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
    logger = create_logger(output_dir / (f'train_rank{rank}.log'
                                         if world > 1 else 'train.log'))

    batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    num_epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)
    dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True,
                            logger=logger, seed=0)
    # each rank reads len(dataset) / world frames an epoch
    steps_per_epoch = max(len(dataset) // world // batch_size, 1)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    total_steps = steps_per_epoch * num_epochs

    detector = build_detector(cfg, device=device)
    tx, lr_sched = optim_lib.build_optimizer(cfg.OPTIMIZATION, total_steps)
    # the JAX CLI draws an example batch to initialise its train state;
    # drawing it here too keeps the dataset's and the augmentor's random
    # streams in step with it
    next(dataset.iter_batches(batch_size, seed=0, process_rank=rank,
                              process_count=world))
    ts = state_lib.create_train_state(detector, tx)
    if world > 1:
        mesh = mesh_lib.make_mesh(device)
        train_step = mesh_lib.make_dp_train_step(detector, tx, mesh)
    else:
        train_step = state_lib.make_train_step(detector, tx)
    logger.info(f'device {device}, rank {rank} of {world}, batch '
                f'{batch_size} per rank, {steps_per_epoch} steps/epoch, '
                f'{num_epochs} epochs')

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
    if world > 1:
        mesh_lib.put_replicated(ts)

    writer = ScalarWriter(output_dir / 'tensorboard', enabled=rank == 0)
    it = ts.step
    run = {'start_step': it, 'steps': [], 'checkpoints': [],
           'detector': detector}
    prof = None
    for epoch in range(start_epoch, num_epochs):
        t_epoch = time.perf_counter()
        batches = dataset.iter_batches(batch_size, seed=epoch,
                                       process_rank=rank,
                                       process_count=world)
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
        if rank == 0:
            run['checkpoints'].append(ckpt_lib.save_checkpoint(
                ckpt_lib.checkpoint_state(ts, epoch, it), ckpt_dir, epoch,
                args.max_ckpt_save_num))
    writer.close()

    if args.bn_refresh:
        from ..train.bn_refresh import refresh_detector_stats
        # every rank refreshes over the same unsharded stream, so the
        # ranks keep equal statistics
        refresh = [to_device(b, device) for b in itertools.islice(
            dataset.iter_batches(batch_size, seed=num_epochs),
            args.bn_refresh)]
        refresh_detector_stats(detector, refresh)
        if rank == 0:
            run['checkpoints'].append(ckpt_lib.save_checkpoint(
                ckpt_lib.checkpoint_state(ts, num_epochs - 1, it), ckpt_dir,
                num_epochs - 1, args.max_ckpt_save_num))
        logger.info(f'BN stats refreshed over {len(refresh)} batches')
    if args.eval_after_train:
        from .test import eval_checkpoint
        run['eval'] = eval_checkpoint(cfg, detector, output_dir, logger,
                                      batch_size=batch_size)
    if args.coordinator_address is not None:
        distributed.shutdown()
    return run


if __name__ == '__main__':
    main()
