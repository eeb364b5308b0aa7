"""Where the time of a full-width CVAE train step goes, on one GPU.

    python3 -m glenet_tpu_torch.profile_cvae

configs/cvae/exp_gen.yaml at full width (B = 64 crops of 512 points,
LATENT_DIM 8), weights from build_generator's seed, adam_onecycle over a
full run's schedule; N_BATCHES batches of training items of a synthetic
crop database (utils/synthetic.write_crop_database), drawn before the
timing and fed in turn.
Two warm-up steps, then:
  1. the wall time of STEPS steps, each ending in a synchronise;
  2. per-stage wall times with a synchronise at every stage boundary:
     forward, loss, backward, optimizer (clip and adam_onecycle);
  3. the host-device synchronisations one step makes, counted with
     torch.cuda.set_sync_debug_mode and listed by the line that made them;
  4. a torch.profiler window over STEPS steps: the device busy share and
     the top device operators;
  5. the same for `sample` (one prediction batch).
Prints the card's name and power limit beside the numbers.
"""
from __future__ import annotations

import collections
import itertools
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from .config import Cfg, cfg_from_yaml_file
from .cvae import dataset as cds
from .cvae import model as cm
from .cvae import pipeline
from .train import optim
from .utils.cuda_timing import card_line, profile_window
from .utils.synthetic import write_crop_database

ROOT = Path(__file__).resolve().parent.parent
STEPS, TOP, N_CROPS, N_BATCHES = 10, 15, 800, 8


def _batches(cfg, root, n):
    data = Cfg(dict(cfg.DATA_CONFIG, FOLD_IDX=0, NUM_FOLDS=5))
    ds = cds.KittiGtDataset(data, training=True, root_path=root)
    ds.rng = np.random.RandomState(0)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    it = ds.iter_batches(b, seed=0)
    return [pipeline.to_device(next(it), 'cuda') for _ in range(n)]


def _staged_step(gen, cfg, tx, opt_state, batch, generator):
    """One train step written out with a synchronise between its stages
    -> {stage: ms}."""
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    params = list(gen.parameters())
    for p in params:
        p.grad = None
    out = gen(batch['points'], batch['gt_boxes_input'], generator)
    mark()
    reg, latent, regular, _ = cm.cvae_loss(
        out, batch['gt_boxes'], params, cfg.MODEL.LOSS_CONFIG.LOSS_WEIGHTS)
    total = reg + 0.5 * latent + regular
    mark()
    total.backward()
    mark()
    tx.update(params, [p.grad for p in params], opt_state)
    mark()
    return {k: 1e3 * (b - a) for k, a, b in zip(
        ('forward', 'loss', 'backward', 'optimizer'), marks, marks[1:])}


def _syncs(fn):
    """Run fn() with sync debug warnings on -> Counter of 'file:line' of
    each synchronising call."""
    counts = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    for w in caught:
        if 'synchroniz' in str(w.message):
            counts[f'{Path(w.filename).name}:{w.lineno}'] += 1
    return counts


def _profile(fn, n, card, what):
    wall, dev, events = profile_window(fn, n)
    cuda = torch.autograd.DeviceType.CUDA
    n_kernels = sum(e.count for e in events if e.device_type == cuda)
    print(f'{what}: profiled window of {n}, wall {wall:.2f} ms, device '
          f'kernel time {dev:.2f} ms ({n_kernels / n:.0f} device operators '
          f'per call), busy share {dev / wall:.3f} (card: {card})')
    print(events.table(sort_by='self_device_time_total', row_limit=TOP,
                       max_name_column_width=50))


def main():
    if not torch.cuda.is_available():
        raise SystemExit('profile_cvae: no CUDA device')
    card = card_line()
    print(f'card: {card}')
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/cvae/exp_gen.yaml'))
    with tempfile.TemporaryDirectory(prefix='cvae_profile_') as tmp:
        write_crop_database(tmp, N_CROPS, seed=0)
        batches = _batches(cfg, tmp, N_BATCHES)
    gen = pipeline.build_generator(cfg.MODEL, 'cuda', seed=0)
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 400 * 220)
    opt_state = tx.init(list(gen.parameters()))
    step = pipeline.make_cvae_train_step(gen, cfg.MODEL, tx)
    generator = torch.Generator(device='cuda').manual_seed(0)
    feed = itertools.cycle(batches)
    for _ in range(2):
        step(opt_state, next(feed), generator, 0.5)
    torch.cuda.synchronize()

    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(STEPS):
        batch = next(feed)
        t0 = time.perf_counter()
        step(opt_state, batch, generator, 0.5)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f'CVAE train step, B={batches[0]["points"].shape[0]}: '
          f'{STEPS} steps, mean {np.mean(times):.2f} ms, min '
          f'{np.min(times):.2f}, max {np.max(times):.2f}; peak device '
          f'memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')

    stages = collections.defaultdict(float)
    for _ in range(STEPS):
        for k, v in _staged_step(gen, cfg, tx, opt_state, next(feed),
                                 generator).items():
            stages[k] += v / STEPS
    print('stage wall times, synchronised at each boundary, mean of '
          f'{STEPS} steps (ms): ' + ', '.join(
              f'{k} {v:.2f}' for k, v in stages.items()))

    syncs = _syncs(lambda: step(opt_state, next(feed), generator, 0.5))
    print(f'host-device synchronisations in one step: '
          f'{sum(syncs.values())} (' + ', '.join(
              f'{k} x{v}' for k, v in syncs.most_common()) + ')')
    _profile(lambda: step(opt_state, next(feed), generator, 0.5), STEPS,
             card, 'train step')

    points = batches[0]['points']
    with torch.no_grad():
        syncs = _syncs(lambda: gen.sample(points, generator))
        print(f'host-device synchronisations in one sample: '
              f'{sum(syncs.values())} (' + ', '.join(
                  f'{k} x{v}' for k, v in syncs.most_common()) + ')')
        _profile(lambda: gen.sample(points, generator), STEPS, card,
                 'sample')


if __name__ == '__main__':
    main()
