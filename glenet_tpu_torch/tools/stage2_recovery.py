"""Stage-2 recovery on the convergence harness (the port's counterpart of
the repository's tools/stage2_recovery.py).

A converted reference GLENet-VR checkpoint carries a good stage 1 (VFE,
sparse backbone, BEV backbone, anchor head) and an RoI stage that cannot
be converted exactly, so the migration recipe is "keep stage 1,
re-initialise stage 2, fine-tune briefly".  This measures the recipe:

  1. load the converged GLENet-VR checkpoint of convergence_ap.py
     (<tempdir>/conv_torch_GLENet_VR/; else the JAX harness's
     conv_GLENet_VR/variables.msgpack in the temp directory);
  2. re-initialise the RoI head, parameters and BN stats, from a fresh
     detector drawn from seed 7;
  3. fine-tune with stage 1's gradients zeroed (not detached: the clip's
     global norm counts only the RoI head, AdamW's decoupled decay still
     shrinks stage 1 by lr * 0.01 * p every step, and stage 1's BN stats
     keep moving in train mode);
  4. re-estimate the BN stats and score the training scenes with the KITTI
     evaluator.

    python -m glenet_tpu_torch.tools.stage2_recovery [n_steps] [peak_lr]
        [--device cpu] [--out FILE]

Defaults: 200 steps, peak LR 1e-3.  Merges 'GLENet_VR_stage2_recovery'
into CONVERGENCE_AP_TORCH.json at the repository root (or --out).  Runs on
the GPU unless --device cpu is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import convergence_ap as ca
from .train import synchronize

STAGE2 = 'roi_head.'
REINIT_SEED = 7
MODEL_YAML = 'configs/kitti_models/GLENet_VR.yaml'


def checkpoint_sources():
    """(the port's checkpoint directory, the JAX harness's variables)."""
    tmp = Path(tempfile.gettempdir())
    return (tmp / 'conv_torch_GLENet_VR',
            tmp / 'conv_GLENet_VR' / 'variables.msgpack')


def load_converged(det):
    """The converged GLENet-VR weights and BN stats into `det`; returns the
    file read.  Exits when neither harness has left one."""
    from ..train import checkpoint, jax_checkpoint
    from ..utils.jax_weights import load_jax_variables
    port_dir, jax_file = checkpoint_sources()
    path = checkpoint.find_latest_checkpoint(port_dir)
    if path is not None:
        det.net.load_state_dict(checkpoint.load_checkpoint(path)[
            'model_state'])
        return path
    if jax_file.exists():
        load_jax_variables(det.net, jax_checkpoint.msgpack_restore(
            jax_file.read_bytes()))
        return str(jax_file)
    sys.exit('run glenet_tpu_torch/tools/convergence_ap.py for GLENet_VR '
             f'first (missing {port_dir})')


def reinit_stage2(det, fresh):
    """Copy `fresh`'s RoI head (parameters and buffers) into `det`; returns
    the number of tensors copied."""
    src = {k: v for k, v in fresh.net.state_dict().items()
           if k.startswith(STAGE2)}
    dst = det.net.state_dict()
    with torch.no_grad():
        for k, v in src.items():
            dst[k].copy_(v)
    return len(src)


def finetune_stage2(det, batches, n_steps, peak_lr):
    """n_steps of the harness's optimizer with every gradient outside the
    RoI head zeroed; step i draws from step generator 500 + i.  Returns
    the last loss."""
    from ..train.state import step_generator
    tx = ca.harness_optimizer(n_steps, peak_lr)
    named = list(det.net.named_parameters())
    params = [p for _, p in named]
    frozen = [not n.startswith(STAGE2) for n, _ in named]
    opt_state = tx.init(params)
    t0 = time.time()
    loss = torch.tensor(float('nan'))
    for i in range(n_steps):
        for p in params:
            p.grad = None
        loss, _ = det.loss_fn(batches[i % len(batches)],
                              generator=step_generator(500 + i, det.device))
        loss.backward()
        loss = loss.detach()
        grads = [torch.zeros_like(p) if f or p.grad is None else p.grad
                 for p, f in zip(params, frozen)]
        tx.update(params, grads, opt_state)
        if i % 25 == 0 or i == n_steps - 1:
            print(f'step {i}: loss={float(loss):.3f} '
                  f'({time.time() - t0:.0f}s)', flush=True)
    return float(loss)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('n_steps', nargs='?', type=int, default=200)
    parser.add_argument('peak_lr', nargs='?', type=float, default=1e-3)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--out', default=str(ca.RESULTS),
                        help='the results file to merge the entry into')
    return parser.parse_args(argv)


def main(argv=None):
    """Returns (the entry, the fine-tuned detector)."""
    from ..eval import kitti_eval
    from ..train.bn_refresh import refresh_detector_stats
    from ..utils.calibration_kitti import Calibration

    args = parse_args(argv)
    cfg = ca.load_cfg(MODEL_YAML)
    ca.zero_score_thresholds(cfg)
    det = ca.fresh_detector(cfg, args.device, seed=REINIT_SEED)
    fresh = ca.fresh_detector(cfg, args.device, seed=REINIT_SEED)
    device = det.device
    scenes = [ca.make_scene(s) for s in range(ca.N_SCENES)]
    batches = ca.make_batches(scenes, ca.BATCH, ca.MAX_POINTS, ca.N_GT,
                              device)

    # stage 1 from the converged run, stage 2 from scratch: what a user of
    # a converted reference checkpoint starts from
    print(f'stage 1 from {load_converged(det)}', flush=True)
    n = reinit_stage2(det, fresh)
    del fresh
    print(f'roi_head re-initialized: {n} tensors (parameters and BN stats)',
          flush=True)

    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    loss = finetune_stage2(det, batches, args.n_steps, args.peak_lr)
    synchronize(device)
    step_ms = 1e3 * (time.time() - t0) / max(args.n_steps, 1)
    refresh_detector_stats(det, batches)

    calib = Calibration(ca.CALIB)
    gt_annos, dt_annos = ca.kitti_annos(det, scenes, batches, calib,
                                        diag=False)
    result_str, ret = kitti_eval.get_official_eval_result(
        gt_annos, dt_annos, ['Car'], device=device)
    print(result_str)

    out = {
        'model': 'GLENet_VR stage-1 kept / roi_head reinit + frozen-stage-1 '
                 'fine-tune (converted-checkpoint recovery recipe)',
        'n_scenes': ca.N_SCENES, 'n_steps': args.n_steps,
        'final_loss': loss,
        'Car_3d_moderate_R40': ret.get('Car_3d/moderate_R40'),
        'Car_bev_moderate_R40': ret.get('Car_bev/moderate_R40'),
        'wall_clock_s': round(time.time() - t0, 1),
        'device': ca.device_line(device),
        'ms_per_step': round(step_ms, 2),
        'peak_gib': ca.peak_gib(device),
    }
    ca.merge_entry('GLENet_VR_stage2_recovery', out, args.out)
    print(json.dumps(out))
    return out, det


if __name__ == '__main__':
    main()
