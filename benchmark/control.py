"""Readings that set the limits of `correct`: the program's numbers, the
control's and each planted fault's, over many seeds in one process.

    python3 benchmark/control.py --workload NAME --seeds 1,2,3 \
        --what program,control,fault:unchanged --out FILE.jsonl

`program`: the timed call on the cell's inputs (the checked train steps,
or `checked_requests` requests on the first frames), against the
reference.  `control`: the reference in the nearest lower precision
(reference/common.Precision('fp8')) in the program's place.  `fault:<name>`:
the program with one fault of FAULTS planted under the timed call.
`program_f32`: the program on its own float32 path, a second witness.  Each
reading is one JSON line {workload, seed, what, numbers}.  Runs on the GPU
(or, for the tests, on the CPU with a tiny cell).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _patched(owner, attr, make):
    real = getattr(owner, attr)
    setattr(owner, attr, make(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)


def fault_unchanged():
    """The train step returns its state unchanged: no optimizer update."""
    from glenet_tpu_torch.train import optim
    return _patched(optim.AdamOneCycle, 'update',
                    lambda real: lambda self, params, grads, state, norm=None:
                    real(self, [p.detach().clone() for p in params], grads,
                         state, norm))


def fault_half_batch():
    """Half of the batch left out of the loss, the mean taken over the
    rest."""
    from glenet_tpu_torch.models.detectors import Detector

    def make(real):
        def loss_fn(self, batch, generator=None):
            half = batch['points'].shape[0] // 2
            return real(self, {k: v[:half] for k, v in batch.items()},
                        generator)
        return loss_fn
    return _patched(Detector, 'loss_fn', make)


def fault_altered():
    """One answer altered where it is produced: the first final box moved
    half a metre along x."""
    from glenet_tpu_torch.models.detectors import Detector

    def make(real):
        def predict(self, batch):
            out = real(self, batch)
            out['final_boxes'][:, 0, 0] += 0.5
            return out
        return predict
    return _patched(Detector, 'predict', make)


def fault_loss_sign():
    """A loss term with its sign flipped: the direction-bin term enters
    the total with a minus (the terms reported stay as they are)."""
    from glenet_tpu_torch.models.detectors import Detector

    def make(real):
        def compute_loss(self, full_out, batch):
            total, metrics = real(self, full_out, batch)
            total = total - 2.0 * metrics['loss_dir']
            metrics['loss'] = total
            return total, metrics
        return compute_loss
    return _patched(Detector, 'compute_loss', make)


def fault_loss_scale():
    """A loss term scaled where it is computed: the KL-label regression
    term (and each of its parts) doubled."""
    from glenet_tpu_torch.models import anchor_heads

    def make(real):
        def reg_loss_kl_label(*args, **kw):
            loss, parts = real(*args, **kw)
            return 2.0 * loss, {k: 2.0 * v for k, v in parts.items()}
        return reg_loss_kl_label
    return _patched(anchor_heads, 'reg_loss_kl_label', make)


@contextlib.contextmanager
def fault_backward_taps():
    """Part of the backward's arithmetic left out: the submanifold sparse
    convolutions' weight gradient drops its last block of three taps."""
    from glenet_tpu_torch.ops import sparse
    fn = sparse._SubmGatherGemm
    real = fn.__dict__['backward']

    def backward(ctx, g):
        d_f, q, tbl, d_w = real.__func__(ctx, g)
        if d_w is not None:
            d_w = d_w.clone()
            d_w[-3:] = 0
        return d_f, q, tbl, d_w
    fn.backward = staticmethod(backward)
    try:
        yield
    finally:
        fn.backward = real


def fault_skip_nms():
    """The final NMS left out: every live candidate is kept, up to
    NMS_POST_MAXSIZE."""
    from glenet_tpu_torch.ops import nms

    def make(real):
        def nms_bev(boxes, scores, iou_threshold, *args, **kw):
            return real(boxes, scores, 2.0, *args, **kw)
        return nms_bev
    return _patched(nms, 'nms_bev', make)


def program_f32():
    """Not a fault: the program's own float32 path (its bf16 switches
    off), a second witness beside the reference."""
    from glenet_tpu_torch.models import spconv_backbone
    from glenet_tpu_torch.ops import sparse
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(sparse, 'GATHER_COMPUTE_DTYPE',
                                 lambda real: None))
    stack.enter_context(_patched(spconv_backbone, 'DENSE_MXU_DTYPE',
                                 lambda real: None))
    return stack


FAULTS = {'train': {'unchanged': fault_unchanged,
                    'half_batch': fault_half_batch,
                    'loss_sign': fault_loss_sign,
                    'loss_scale': fault_loss_scale,
                    'backward_taps': fault_backward_taps},
          'predict': {'altered': fault_altered, 'skip_nms': fault_skip_nms}}


def readings(h, seed, what):
    """One reading of `what` on `seed` -> numbers (per request, the worst
    over the checked requests)."""
    from benchmark import compare
    from benchmark.drivers import predict, train
    kind = h.traffic['kind']
    drv = train if kind == 'train' else predict
    if what.startswith('fault:'):
        fault = FAULTS[kind][what.split(':', 1)[1]]()
    elif what == 'program_f32':
        fault = program_f32()
    else:
        fault = contextlib.nullcontext()
    with fault:
        s = drv.Session(h, seed)
        if what == 'control':
            prog = None
        elif kind == 'train':
            prog = s.first_steps()
        else:
            for _ in range(int(h.traffic['checked_requests'])):
                s.call()
        s.release()
    if kind == 'train':
        return drv.reference_numbers(h, s.pool, s.w0, prog)
    requests = [(i, host) for i, _, host in s.served]
    if what == 'control':
        requests = [(i, None) for i in range(
            int(h.traffic['checked_requests']))]
    return compare.worst(drv.reference_readings(
        h, s.pool, s.w0, requests, control=what == 'control'))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--what', default='program,control')
    p.add_argument('--out', required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    _, _, conf, config, traffic, limits = harness.find_cell(ROOT,
                                                           args.workload)
    h = types.SimpleNamespace(config=config, conf=conf, traffic=traffic,
                              limits=limits, device=torch.device('cuda', 0))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for what in args.what.split(','):
        for seed in (int(s) for s in args.seeds.split(',')):
            t = time.perf_counter()
            numbers = readings(h, seed, what)
            line = json.dumps({'workload': args.workload, 'seed': seed,
                               'what': what, 'numbers': numbers,
                               'seconds': time.perf_counter() - t})
            print(line, flush=True)
            with out.open('a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
