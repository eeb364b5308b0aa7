"""Checkpoints of a training run (the port's counterpart of
glenet_tpu/train/checkpoint.py), with the same resume rules:
  - one file per epoch, `checkpoint_epoch_{N}.pth`: {epoch, it,
    model_state (the net's state_dict: parameters and BN running stats),
    optimizer_state, step};
  - auto-resume from the newest epoch in the directory;
  - pruned to the `max_ckpt_save_num` most recent files.
Written with torch.save and read with torch.load(weights_only=True), so a
checkpoint holds only tensors, numbers, strings and containers of them.
"""
from __future__ import annotations

import glob
import os
import re
from pathlib import Path

import torch

PATTERN = 'checkpoint_epoch_*.pth'


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def checkpoint_state(train_state, epoch: int, it: int):
    return {'epoch': epoch, 'it': it,
            'model_state': _to_cpu(train_state.net.state_dict()),
            'optimizer_state': _to_cpu(train_state.opt_state),
            'step': int(train_state.step)}


def _epoch_of(path) -> int:
    m = re.search(r'checkpoint_epoch_(\d+)', str(path))
    return int(m.group(1)) if m else -1


def save_checkpoint(state_dict, ckpt_dir, epoch: int,
                    max_ckpt_save_num: int = 30):
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f'checkpoint_epoch_{epoch}.pth'
    tmp = path.with_suffix('.tmp')
    torch.save(state_dict, tmp)
    os.replace(tmp, path)
    # prune the oldest
    ckpts = sorted(glob.glob(str(ckpt_dir / PATTERN)),
                   key=lambda p: (os.path.getmtime(p), _epoch_of(p)))
    while len(ckpts) > max_ckpt_save_num:
        os.remove(ckpts.pop(0))
    return str(path)


def find_latest_checkpoint(ckpt_dir):
    ckpts = glob.glob(str(Path(ckpt_dir) / PATTERN))
    return max(ckpts, key=_epoch_of) if ckpts else None


def load_checkpoint(path):
    return torch.load(path, map_location='cpu', weights_only=True)


def _restore_into(current, saved):
    """`saved` (from a checkpoint) in place of `current`: tensors are copied
    into the current ones, so they keep their device; numbers are taken
    from `saved`."""
    if torch.is_tensor(saved):
        if not torch.is_tensor(current) or current.shape != saved.shape:
            raise ValueError(f'checkpoint tensor of shape '
                             f'{tuple(saved.shape)} has no counterpart here')
        return current.copy_(saved)
    if isinstance(saved, dict):
        current = current if isinstance(current, dict) else {}
        return {k: _restore_into(current.get(k), v) for k, v in saved.items()}
    if isinstance(saved, list):
        if not isinstance(current, list) or len(current) != len(saved):
            raise ValueError(f'checkpoint list of {len(saved)} entries has '
                             f'no counterpart here')
        return [_restore_into(c, v) for c, v in zip(current, saved)]
    return saved


def restore_train_state(train_state, ckpt):
    """Apply a loaded checkpoint onto a TrainState in place: parameters and
    BN stats, optimizer state, step."""
    train_state.net.load_state_dict(ckpt['model_state'])
    train_state.opt_state = _restore_into(train_state.opt_state,
                                          ckpt['optimizer_state'])
    train_state.step = int(ckpt['step'])
    return train_state
