"""What the benchmark takes from the program under test, the PyTorch and
CUDA port `glenet_tpu_torch`: its detector built from the configuration
through the port's normal path, its train step, and the names of the
modules and functions the spans and ranges wrap.  Nothing else of the
benchmark imports the port, and the references never do.
"""
from __future__ import annotations

import copy

from . import weights as wlib

def build(config, device):
    """The configuration file's dict -> (Cfg, Detector on `device`)."""
    from glenet_tpu_torch.config import Cfg, merge_new_config
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = merge_new_config(Cfg(), copy.deepcopy(config['config']))
    return cfg, build_detector(cfg, device=device)


def load_seeded(det, config, seed, device):
    """Draw the weights from `seed` (benchmark/weights.py), load them into
    the detector, return them (the reference's copy)."""
    sd = det.net.state_dict()
    layout = [(k, tuple(v.shape)) for k, v in sd.items()]
    bn = {n for n, m in det.net.named_modules()
          if type(m).__name__ == 'MaskedBatchNorm'}
    w = wlib.seeded_weights(layout, bn, seed, device, config['assumed'])
    det.net.load_state_dict(w)
    return w


def train_step(det, cfg, total_steps):
    """(train_step, state, parameter names in the optimizer's order)."""
    from glenet_tpu_torch.train.optim import build_optimizer
    from glenet_tpu_torch.train.state import (create_train_state,
                                              make_train_step)
    tx, _ = build_optimizer(cfg.OPTIMIZATION, total_steps)
    state = create_train_state(det, tx)
    names = [n for n, _ in det.net.named_parameters()]
    return make_train_step(det, tx), state, names


def merge_module():
    """The module whose `resolve_sorted_queries` the sparse tables call."""
    from glenet_tpu_torch.ops import merge_kernel
    return merge_kernel
