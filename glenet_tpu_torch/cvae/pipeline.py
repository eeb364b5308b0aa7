"""CVAE training, prediction, uncertainty mapping and injection (torch
counterpart of glenet_tpu/cvae/pipeline.py):
  1. K-fold training of the CVAE on per-object crops with KL annealing
     (linear 0 -> 1 over the epochs): loss = reg + anneal * latent +
     regular, then the global-norm clip and adam_onecycle;
  2. N stochastic prediction passes per fold (z from the prior);
  3. the per-object variance of the 7 normalised box dims across the
     passes, the heading aligned to the gt (limit_period, then sin);
  4. injection of `uncertainty` into the infos and the gt database (a -1
     vector for objects of other classes).

Draws come from explicit torch.Generators on the model's device, seeded
from the JAX package's seeds: `seed` for a fold's training (the pipeline
passes seed + fold) and `seed * 1000 + pass` for each prediction pass.
The initial weights come from a CPU generator seeded with the training
seed, so they do not depend on the device.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from ..config import Cfg
from ..train import optim as optim_lib
from ..utils.common import limit_period_np, resolve_device
from .model import CVAEGenerator, cvae_loss

BATCH_KEYS = ('points', 'gt_boxes', 'gt_boxes_input')


def build_generator(model_cfg, device=None, seed: int = 0):
    """The CVAE of MODEL, initialised as flax initialises it from a CPU
    generator seeded with `seed`, on `device` (the GPU when None; without
    one it raises unless given 'cpu')."""
    device = resolve_device(device)
    gen = CVAEGenerator(latent_dim=int(model_cfg.LATENT_DIM),
                        num_bins=int(model_cfg.get('NUM_DIR_BINS', 2)),
                        in_channels=int(model_cfg.get('INPUT_CHANNELS', 4)))
    gen.reset_parameters(torch.Generator().manual_seed(seed))
    return gen.to(device)


def to_device(batch, device):
    """The arrays a train step reads, as tensors on `device`."""
    return {k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS}


def make_cvae_train_step(gen, model_cfg, tx):
    """Returns train_step(opt_state, batch, generator, anneal) -> metrics
    (0-dim tensors on the device: loss, reg_loss, latent_loss,
    regular_loss, loss_loc, loss_dir, grad_norm).  The parameters and the
    BN running stats of `gen` are updated in place."""
    lw = model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
    dir_offset = float(model_cfg.get('DIR_OFFSET', 0.78539))
    num_bins = int(model_cfg.get('NUM_DIR_BINS', 2))
    params = list(gen.parameters())

    def train_step(opt_state, batch, generator, anneal):
        for p in params:
            p.grad = None
        out = gen(batch['points'], batch['gt_boxes_input'], generator,
                  train=True)
        reg, latent, regular, parts = cvae_loss(
            out, batch['gt_boxes'], params, lw, num_bins=num_bins,
            dir_offset=dir_offset)
        total = reg + anneal * latent + regular
        total.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        metrics = {'loss': total, 'reg_loss': reg, 'latent_loss': latent,
                   'regular_loss': regular, **parts}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics['grad_norm'] = tx.update(params, grads, opt_state)
        return metrics

    return train_step


def train_cvae(cfg, dataset, seed=0, log_every=50, logger=None,
               num_epochs=None, device=None):
    """The whole training loop of one fold; returns the trained CVAE."""
    device = resolve_device(device)
    gen = build_generator(cfg.MODEL, device, seed)
    opt_cfg = cfg.OPTIMIZATION
    batch_size = int(opt_cfg.BATCH_SIZE_PER_GPU)
    num_epochs = num_epochs or int(opt_cfg.NUM_EPOCHS)
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    tx, _ = optim_lib.build_optimizer(opt_cfg, steps_per_epoch * num_epochs)
    # the JAX package draws an example batch to initialise its variables;
    # drawing it here too keeps the dataset's numpy draws in step with it
    next(dataset.iter_batches(batch_size, seed=seed))
    opt_state = tx.init(list(gen.parameters()))
    step_fn = make_cvae_train_step(gen, cfg.MODEL, tx)
    generator = torch.Generator(device=device).manual_seed(seed)

    it = 0
    for epoch in range(num_epochs):
        anneal = min((epoch + 1) / num_epochs, 1.0)
        dataset.linear_anneal = anneal
        for batch in dataset.iter_batches(batch_size,
                                          seed=seed * 10000 + epoch):
            metrics = step_fn(opt_state, to_device(batch, device), generator,
                              anneal)
            if logger and it % log_every == 0:
                logger.info(
                    f'epoch {epoch} it {it} loss {float(metrics["loss"]):.4f} '
                    f'reg {float(metrics["reg_loss"]):.4f} '
                    f'latent {float(metrics["latent_loss"]):.4f}')
            it += 1
    return gen


@torch.no_grad()
def predict_samples(gen, dataset, model_cfg, n_passes=30, batch_size=64,
                    seed=0):
    """N stochastic passes over the (val-fold) dataset.

    Returns a list of n_passes dicts: "{frame_id}_{gt_id}" ->
    {'pred_box': (7,), 'gt_box': (7,)} in normalised coordinates."""
    dir_offset = float(model_cfg.get('DIR_OFFSET', 0.78539))
    dir_limit = float(model_cfg.get('DIR_LIMIT_OFFSET', 0.0))
    device = next(gen.parameters()).device
    results = []
    for pass_idx in range(n_passes):
        generator = torch.Generator(device=device).manual_seed(
            seed * 1000 + pass_idx)
        out = {}
        for batch in dataset.iter_batches(batch_size, shuffle=False,
                                          drop_last=False):
            pred = gen.sample(torch.from_numpy(batch['points']).to(device),
                              generator, dir_offset, dir_limit).cpu().numpy()
            for i in range(len(batch['frame_id'])):
                key = f"{batch['frame_id'][i]}_{batch['gt_id'][i]}"
                out[key] = {'pred_box': pred[i, :7],
                            'gt_box': batch['gt_boxes'][i]}
        results.append(out)
    return results


def mapping_uncertainty(per_pass_results):
    """Across-pass variance per object: key -> (7,) variance in the
    normalised box space."""
    out = {}
    for key in per_pass_results[0].keys():
        preds = np.stack([r[key]['pred_box'] for r in per_pass_results
                          if key in r])
        gt_angle = per_pass_results[0][key]['gt_box'][6]
        h = limit_period_np(preds[:, 6] - gt_angle, 0, 2 * np.pi)
        preds = preds.copy()
        preds[:, 6] = np.sin(h)
        out[key] = np.var(preds[:, :7], axis=0)
    return out


def change_gt_infos(uncertainty_map, kitti_infos, db_infos,
                    car_class='Car'):
    """Mutates and returns (kitti_infos, db_infos): every annotation gets
    annos['uncertainty'] ((-1,) * 7 for other classes), every Car entry of
    the gt database gets info['uncertainty']."""
    for info in kitti_infos:
        frame_id = info['image']['image_idx']
        names = info['annos']['name']
        unc = []
        for i, idx in enumerate(info['annos']['index']):
            if names[i] != car_class:
                unc.append(np.full(7, -1.0))
            else:
                unc.append(np.asarray(uncertainty_map[f'{frame_id}_{idx}']))
        info['annos']['uncertainty'] = np.array(unc)

    for info in db_infos.get(car_class, []):
        key = f"{info['image_idx']}_{info['gt_idx']}"
        info['uncertainty'] = np.asarray(uncertainty_map[key])
    return kitti_infos, db_infos


def change_gt_infos_waymo(uncertainty_map, waymo_infos, db_infos,
                          vehicle_class='Vehicle'):
    """Waymo's injection: the frame key is '{sequence}#{sample_idx}', other
    classes get -1; every Vehicle entry of the gt database gets
    info['uncertainty']."""
    for info in waymo_infos:
        frame_id = (info['point_cloud']['lidar_sequence'] + '#'
                    + str(info['point_cloud']['sample_idx']))
        names = info['annos']['name']
        unc = []
        for idx in range(len(names)):
            if names[idx] != vehicle_class:
                unc.append(np.full(7, -1.0))
            else:
                unc.append(np.asarray(uncertainty_map[f'{frame_id}_{idx}']))
        info['annos']['uncertainty'] = (np.array(unc) if unc
                                        else np.zeros((0, 7)))

    for info in db_infos.get(vehicle_class, []):
        frame_id = info['sequence_name'] + '#' + str(info['sample_idx'])
        info['uncertainty'] = np.asarray(
            uncertainty_map[f"{frame_id}_{info['gt_idx']}"])
    return waymo_infos, db_infos


def run_kfold_pipeline(cfg, root_path, n_folds=10, n_passes=30, seed=0,
                       logger=None, num_epochs=None, infos=None,
                       output_dir=None, device=None):
    """K-fold training, the passes over each fold's val split and the
    variance map of every object (written to <output_dir>/un_v4.pkl).
    DATA_CONFIG.DATASET selects the KITTI or the Waymo crop dataset."""
    from .dataset import KittiGtDataset, WaymoGtDataset
    device = resolve_device(device)
    ds_cls = (WaymoGtDataset
              if cfg.DATA_CONFIG.get('DATASET') == 'WaymoGtDataset'
              else KittiGtDataset)
    uncertainty_map = {}
    for fold in range(n_folds):
        fold_cfg = Cfg(dict(cfg.DATA_CONFIG, FOLD_IDX=fold,
                            NUM_FOLDS=n_folds))
        train_ds = ds_cls(fold_cfg, training=True, root_path=root_path,
                          logger=logger, infos=infos)
        val_ds = ds_cls(fold_cfg, training=False, root_path=root_path,
                        logger=logger, infos=infos)
        if logger:
            logger.info(f'fold {fold}: train {len(train_ds)} val {len(val_ds)}')
        gen = train_cvae(cfg, train_ds, seed=seed + fold, logger=logger,
                         num_epochs=num_epochs, device=device)
        per_pass = predict_samples(
            gen, val_ds, cfg.MODEL, n_passes=n_passes,
            batch_size=int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), seed=seed)
        uncertainty_map.update(mapping_uncertainty(per_pass))
    if output_dir is not None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / 'un_v4.pkl', 'wb') as f:
            pickle.dump(uncertainty_map, f)
    return uncertainty_map
