"""Train state and the train step (torch counterpart of
glenet_tpu/train/state.py).

One step: the train forward at the train voxel budget (batch-moment BN,
dropout, NMS_CONFIG.TRAIN proposals, RoI sampling), every loss term, the
backward, then the global-norm clip and adam_onecycle.  The BN running
stats update in place during the forward, as the JAX step returns them.
The step's draws come from a torch.Generator on the model's device seeded
from (seed, step), as the JAX step folds the step into PRNGKey(17).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..utils import trace

SEED = 17


@dataclasses.dataclass
class TrainState:
    step: int
    net: nn.Module           # parameters and BN running stats
    opt_state: dict


def create_train_state(detector, tx) -> TrainState:
    """State of a fresh run over `detector`'s current parameters."""
    return TrainState(step=0, net=detector.net,
                      opt_state=tx.init(list(detector.net.parameters())))


def step_generator(step: int, device, seed: int = SEED):
    """The generator of one step's draws (RoI sampling, then dropout)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) + step)
    return gen


def loss_and_grads(detector, state: TrainState, batch, seed: int = SEED):
    """The train forward, every loss term and the backward of one step ->
    (parameters, their gradients, metrics as detached 0-dim tensors); the
    gradients are also left in each parameter's .grad."""
    params = list(state.net.parameters())
    for p in params:
        p.grad = None
    gen = step_generator(state.step, params[0].device, seed)
    loss, metrics = detector.loss_fn(batch, generator=gen)
    with trace.span('backward'):
        loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    return params, grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(detector, tx, seed: int = SEED):
    """Returns train_step(state, batch) -> (state, metrics): metrics are
    0-dim tensors on the device (loss, each loss term, grad_norm); the
    state is updated in place and returned.  The steps across processes
    are parallel/mesh.py's."""

    def train_step(state: TrainState, batch):
        with trace.call_span('train_step'):
            params, grads, metrics = loss_and_grads(detector, state, batch,
                                                    seed)
            with trace.span('optim'):
                metrics['grad_norm'] = tx.update(params, grads,
                                                 state.opt_state)
        state.step += 1
        return state, metrics

    return train_step
