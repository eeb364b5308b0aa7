"""Training cells (traffic kind `train`): the port's train step
(`train/state.make_train_step` over `Detector.loss_fn`, adam_onecycle at
step 0 of the configuration's schedule) in a closed loop over a pool of
batches drawn from the seed.  Each call copies its batch to the card from
pinned memory (non_blocking, as a pin_memory loader does), runs the step
and reads its loss to the host (as tools/train.py logs it).

Set-up builds the detector and its train state once, draws the weights,
and drives the first `checked_steps` steps through the same call; those
steps are the warm-up and what the reference checks.  The window goes on
from there with the same state.
"""
from __future__ import annotations

import time

from .. import compare, flops, frames, harness, program
from ..reference.common import Precision
from . import closed_loop, traced

SPANS = {'backbone3d': ('backbone_3d>', 'backbone_3d<'),
         'head_loss': ('backbone_3d<', 'loss<'),
         'backward_optim': ('loss<', 'end')}


class Session:
    """The program's train state and the call the window drives."""

    def __init__(self, h, seed):
        self.h, self.dev = h, h.device
        self.total_steps = int(h.config['assumed']['total_steps'])
        self.cfg, self.det = program.build(h.config, h.device)
        self.w0 = program.load_seeded(self.det, h.config, seed, h.device)
        self.step_fn, self.state, self.names = program.train_step(
            self.det, self.cfg, self.total_steps)
        self.pool = harness.pinned(frames.make_pool(h.traffic, seed),
                                   h.device)
        self.n_pool, self.batch = self.pool['points'].shape[:2]
        self.cursor, self.metrics = 0, None

    def call(self):
        b = harness.to_device(self.pool, self.cursor % self.n_pool, self.dev)
        self.cursor += 1
        _, self.metrics = self.step_fn(self.state, b)
        return float(self.metrics['loss'])

    def first_steps(self):
        """The checked steps -> the program's losses, first gradients (as
        the optimizer got them: its first moment over 1 - b1) and weights
        after them."""
        prog = {'losses': []}
        for s in range(int(self.h.traffic['checked_steps'])):
            prog['losses'].append(self.call())
            if s == 0:
                prog['terms1'] = {t: float(self.metrics[t])
                                  for t in compare.LOSS_TERMS}
                prog['bn1'] = {n: v.detach().clone() for n, v in
                               self.det.net.state_dict().items()
                               if n.endswith(compare.BN_STATS)}
                b1 = self.state.opt_state['hyperparams'][1]
                prog['grads'] = {n: m.detach() / (1.0 - b1) for n, m in
                                 zip(self.names, self.state.opt_state['mu'])}
        prog['final'] = {n: v.detach().clone()
                         for n, v in self.det.net.state_dict().items()}
        return prog

    def release(self):
        """Drop the program's state; keep the pool and the weights."""
        del self.step_fn, self.state, self.det, self.metrics
        harness.free_cache(self.dev)


def reference_numbers(h, pool, w0, prog):
    """The reference's checked steps from w0 on the pool's first batches,
    and the numbers comparing `prog` to them; prog None compares the
    control (the reference in fp8) instead."""
    k = int(h.traffic['checked_steps'])
    batches = [harness.to_device(pool, i, h.device) for i in range(k)]
    ref_mod = harness.reference(h.config['reference'])
    args = (h.config['config'], h.config['budgets'], w0, batches,
            int(h.config['assumed']['total_steps']))
    keys = ('losses', 'grads', 'final', 'bn1', 'terms1')
    ref = dict(zip(keys, ref_mod.train_steps(*args, Precision('f32'))))
    if prog is None:            # the control: the reference in fp8
        prog = dict(zip(keys, ref_mod.train_steps(*args, Precision('fp8'))))
    return compare.train_numbers(prog, ref, w0)


def run(h):
    s = Session(h, h.seed)
    prog = s.first_steps()
    harness.sync(s.dev)
    setup_peak = harness.peak_bytes(s.dev)
    harness.reset_peak(s.dev)
    out = {'setup_s': time.perf_counter() - h.t0}
    first = s.cursor
    if h.trace:
        det = s.det
        out['trace'] = traced(s.call, h.seconds, h.traffic['profiled_calls'],
                              lambda sp: _attach(sp, det), SPANS,
                              program.merge_module(), s.dev)
        del det
        plain = range(first, first + out['trace']['plain_calls'])
    else:
        lat, t0, t1 = closed_loop(s.call, h.seconds)
        out['e2e'] = {'setup_s': out['setup_s'],
                      'train_scans_per_s': len(lat) * s.batch / (t1 - t0),
                      'peak_mem_gib': harness.peak_bytes(s.dev) / harness.GIB}
    harness.sync(s.dev)
    out['memory_peak_bytes'] = max(setup_peak, harness.peak_bytes(s.dev))
    attempted = s.cursor - first
    s.release()
    numbers = reference_numbers(h, s.pool, s.w0, prog)
    out.update(numbers=numbers, attempted=attempted, failed=0)
    if h.trace:
        out['trace'].update(kind='train', plain_flops=plain_flops(
            h, s.pool, [i % s.n_pool for i in plain], True))
    return out


def plain_flops(h, pool, entries, train):
    """Model FLOPs of the calls on these pool entries."""
    per = {}
    for j in set(entries):
        per[j] = flops.call_flops(
            h.config['config'], h.config['budgets'],
            pool['points'][j].to(h.device),
            pool['points_mask'][j].to(h.device), train)
    return sum(per[j] for j in entries)


def _attach(spans, det):
    spans.hook_module(det.net.backbone_3d, 'backbone_3d')
    spans.wrap(det, 'loss_fn', 'loss')
