"""The optimizers of `build_optimizer` (torch counterpart of
glenet_tpu/train/optim.py): adam_onecycle, adam and sgd, each behind the
same global-norm clip.

adam_onecycle is the reference's fastai-style OneCycle:
  - lr: cosine anneal lr_max / div_factor -> lr_max over pct_start of the
    steps, then lr_max -> (lr_max / div_factor) / 1e4;
  - Adam b1 ("momentum"): moms[0] -> moms[1], then back; b2 = 0.99;
  - decoupled weight decay, added to the Adam update before the LR scale;
  - a global grad-norm clip first.

The update is written out rather than taken from torch.optim so that it is
optax's chain term for term: clip_by_global_norm scales the gradients by
max_norm / norm when norm >= max_norm (torch's clip_grad_norm_ divides by
norm + 1e-6 instead), scale_by_adam divides the bias-corrected first moment
by sqrt(bias-corrected second moment) + 1e-8, add_decayed_weights adds
wd * param, and the LR scales the sum.  The schedules are evaluated at the
count of updates made so far, as optax.inject_hyperparams does.

adam is optax.adamw (b1 0.9, b2 0.999, eps 1e-8, decoupled decay added to
the Adam update before the LR scale, on every parameter); sgd is optax's
add_decayed_weights then sgd with momentum (the decay joins the gradient
before the momentum trace).  The CLIs run both at a constant LR; adam also
takes a schedule (the convergence harness's cosine_onecycle_schedule),
read at the count of updates made so far.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ADAM_B2 = 0.99
ADAM_EPS = 1e-8


def annealing_cos(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def _one_cycle(first: float, peak: float, last: float, total_steps: int,
               pct_start: float):
    """Cosine from `first` to `peak` over pct_start of the steps, then from
    `peak` to `last`."""
    split = int(total_steps * pct_start)

    def schedule(step):
        if step < split:
            return annealing_cos(first, peak,
                                 min(max(step / max(split, 1), 0.0), 1.0))
        pct = min(max((step - split) / max(total_steps - split, 1), 0.0), 1.0)
        return annealing_cos(peak, last, pct)

    return schedule


def onecycle_lr_schedule(lr_max: float, total_steps: int, div_factor: float,
                         pct_start: float):
    low_lr = lr_max / div_factor
    return _one_cycle(low_lr, lr_max, low_lr / 1e4, total_steps, pct_start)


def onecycle_mom_schedule(moms, total_steps: int, pct_start: float):
    return _one_cycle(moms[0], moms[1], moms[0], total_steps, pct_start)


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule: cosine from peak / div_factor up to
    peak at step int(pct_start * T), then down to peak / (div_factor *
    final_div_factor) at T, held after T.  Rounded as optax's float32 trace
    rounds it: the segment ends and half-spans are float64 numpy values
    cast to f32, the fraction and the interpolation f32."""
    if transition_steps <= 0:
        raise ValueError('a onecycle schedule needs transition_steps > 0')
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    ends = values[1:].astype(np.float32)
    half = ((values[:-1] - values[1:]) / 2.0).astype(np.float32)
    last = float(np.float32(values[-1]))

    def schedule(count: int) -> float:
        for i in (0, 1):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= count < hi:
                pct = np.float32(count - lo) / np.float32(hi - lo)
                arg = np.float32(np.float32(math.pi) * pct)
                cos = np.float32(math.cos(float(arg)))
                return float(ends[i] + half[i] * (cos + np.float32(1.0)))
        return last if count >= bounds[-1] else 0.0

    return schedule


def global_norm(tensors):
    """L2 norm over all the tensors, as one f32 scalar tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """-> (grads, each t / norm * max_norm when norm >= max_norm, as optax
    rounds it; the norm before the clip); no clip when max_norm <= 0.
    `norm` given (a tensor-parallel step whose grads are slices) is the
    global norm to clip by."""
    norm = global_norm(grads) if norm is None else norm
    if max_norm > 0:
        keep = norm < max_norm
        grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return grads, norm


def bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class AdamOneCycle:
    """Clip, Adam with the step's b1, decoupled decay, LR.  State: the first
    and second moments of each parameter, the update count and the (lr, b1)
    of the last update."""

    def __init__(self, lr_schedule, b1_schedule, weight_decay: float,
                 max_norm: float):
        self.lr_schedule, self.b1_schedule = lr_schedule, b1_schedule
        self.weight_decay, self.max_norm = weight_decay, max_norm

    def init(self, params):
        return {'count': 0,
                'mu': [torch.zeros_like(p) for p in params],
                'nu': [torch.zeros_like(p) for p in params]}

    def hyperparams(self, count: int):
        """(lr, b1) of the update made after `count` updates."""
        return self.lr_schedule(count), self.b1_schedule(count)

    @torch.no_grad()
    def update(self, params, grads, state, norm=None):
        """Update `params` in place from `grads`; returns the global norm of
        the gradients before the clip (`norm`, when given)."""
        grads, norm = clip_by_global_norm(grads, self.max_norm, norm)
        lr, b1 = self.hyperparams(state['count'])
        state['hyperparams'] = (lr, b1)
        state['count'] += 1
        t = state['count']
        mu, nu = state['mu'], state['nu']
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** t)
        nu_hat = torch._foreach_div(nu, 1.0 - ADAM_B2 ** t)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        return norm


class Adam:
    """optax.adamw behind the clip, at a constant LR or at a schedule's
    (a callable of the update count).  State: the moments, the update
    count."""
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, lr, weight_decay: float, max_norm: float):
        self.lr, self.weight_decay, self.max_norm = lr, weight_decay, max_norm

    def lr_at(self, count: int) -> float:
        """The LR of the update made after `count` updates."""
        return self.lr(count) if callable(self.lr) else self.lr

    def init(self, params):
        return {'count': 0,
                'mu': [torch.zeros_like(p) for p in params],
                'nu': [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params, grads, state, norm=None):
        grads, norm = clip_by_global_norm(grads, self.max_norm, norm)
        lr = self.lr_at(state['count'])
        state['count'] += 1
        t = state['count']
        mu, nu = state['mu'], state['nu']
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.B1)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.B2)
        mu_hat = torch._foreach_div(mu, bias_correction(self.B1, t))
        nu_hat = torch._foreach_div(nu, bias_correction(self.B2, t))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        return norm


class SGD:
    """optax's add_decayed_weights then sgd with momentum, at a constant LR,
    behind the clip.  State: the momentum trace, the update count.  The
    decay and the trace are each one multiply-add, as XLA fuses them."""

    def __init__(self, lr: float, momentum: float, weight_decay: float,
                 max_norm: float):
        self.lr, self.momentum = lr, momentum
        self.weight_decay, self.max_norm = weight_decay, max_norm

    def init(self, params):
        return {'count': 0, 'trace': [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params, grads, state, norm=None):
        grads, norm = clip_by_global_norm(grads, self.max_norm, norm)
        state['count'] += 1
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        trace = torch._foreach_add(grads, state['trace'], alpha=self.momentum)
        state['trace'] = trace
        torch._foreach_add_(params, trace, alpha=-self.lr)
        return norm


def build_optimizer(opt_cfg, total_steps: int):
    """From the reference OPTIMIZATION block -> (optimizer, lr schedule)."""
    name = opt_cfg.OPTIMIZER
    lr = float(opt_cfg.LR)
    wd = float(opt_cfg.get('WEIGHT_DECAY', 0.0))
    clip = float(opt_cfg.get('GRAD_NORM_CLIP', 0.0))
    if name == 'adam_onecycle':
        pct = float(opt_cfg.PCT_START)
        lr_sched = onecycle_lr_schedule(lr, total_steps,
                                        float(opt_cfg.DIV_FACTOR), pct)
        mom_sched = onecycle_mom_schedule(tuple(opt_cfg.MOMS), total_steps,
                                          pct)
        return AdamOneCycle(lr_sched, mom_sched, wd, clip), lr_sched
    if name == 'adam':
        return Adam(lr, wd, clip), lambda step: lr
    if name == 'sgd':
        return SGD(lr, float(opt_cfg.get('MOMENTUM', 0.9)), wd,
                   clip), lambda step: lr
    raise NotImplementedError(f'optimizer {name} is not ported yet')
