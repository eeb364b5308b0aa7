"""Helpers of the port's tests across processes (tests/test_torch_parallel*
.py): `launch` runs a function of this module on N gloo ranks, each a
subprocess with one torch thread that imports torch and the port only;
`reference_step` is the one-process step on the whole global batch that
the ranks' steps are held to, with `capture`'s integer outputs.

Run as a script it is one rank:
    python tests/torch_dist.py FUNCTION RANK WORLD PORT DIR
reads DIR/payload.pt, joins the group at 127.0.0.1:PORT, calls
FUNCTION(rank, world, payload) and saves its result to DIR/rank<RANK>.pt.
Ranks run with f32 gathers and dense levels: the parent runs its
references inside torch_parity.pinned_f32().
"""
from __future__ import annotations

import contextlib
import copy
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launch(function, world, payload, tmp_path, timeout=600):
    """FUNCTION(rank, world, payload) on `world` gloo ranks -> their
    results in rank order."""
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp_path / 'payload.pt')
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, __file__, function, str(r), str(world), port,
         str(tmp_path)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} failed:\n{out[-6000:]}'
    return [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the step and what it decides
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def capture(det):
    """Record the step's integer decisions: anchor targets (per sample),
    CenterHead targets (per sample), the train forward's proposals and
    sampled RoI targets, and every merge-resolve table."""
    from glenet_tpu_torch.models import center_head
    from glenet_tpu_torch.ops import merge_kernel
    rec = {'anchor': [], 'center': [], 'merge': [], 'out': []}
    orig = (det.assign_targets, center_head.assign_targets_single,
            merge_kernel.resolve_sorted_queries, det.net.forward)

    def assign(*a, **k):
        t = orig[0](*a, **k)
        rec['anchor'].append({'box_cls_labels': t.box_cls_labels})
        return t

    def center(*a, **k):
        t = orig[1](*a, **k)
        rec['center'].append({'inds': t[2], 'mask': t[3]})
        return t

    def merge(*a):
        t = orig[2](*a)
        rec['merge'].append(t)
        return t

    def forward(*a, **k):
        out = orig[3](*a, **k)
        keep = {}
        if 'proposals' in out:
            keep.update({f'proposals.{n}': out['proposals'][n]
                         for n in ('roi_valid', 'roi_labels')})
        if 'roi_targets' in out:
            keep.update({f'roi_targets.{n}': out['roi_targets'][n]
                         for n in ('reg_valid_mask', 'roi_labels')})
        rec['out'].append(keep)
        return out

    det.assign_targets = assign
    center_head.assign_targets_single = center
    merge_kernel.resolve_sorted_queries = merge
    det.net.forward = forward
    try:
        yield rec
    finally:
        del det.assign_targets, det.net.forward
        center_head.assign_targets_single = orig[1]
        merge_kernel.resolve_sorted_queries = orig[2]


def decisions(rec):
    """capture's record -> {name: int tensor with the batch axis first}."""
    out = {}
    for kind in ('anchor', 'center'):
        for i, t in enumerate(rec[kind]):
            for k, v in t.items():
                out.setdefault(f'{kind}.{k}', []).append(v[None])
    out = {k: torch.cat(v) for k, v in out.items()}
    for i, call in enumerate(rec['merge']):
        for j, v in enumerate(call):
            out[f'merge{i}.{j}'] = v
    for i, fwd in enumerate(rec['out']):
        out.update({f'out{i}.{k}': v for k, v in fwd.items()})
    return {k: v.detach().to(torch.int64) for k, v in out.items()}


def snapshot(det, state, metrics, rec):
    """What a test compares after a step: metrics, parameters, gradients,
    the optimizer moments, the BN statistics and the integer decisions."""
    params = dict(det.net.named_parameters())
    return {
        'metrics': {k: float(v) for k, v in metrics.items()},
        'params': {k: p.detach().clone() for k, p in params.items()},
        'grads': {k: (torch.zeros_like(p) if p.grad is None else
                      p.grad).clone() for k, p in params.items()},
        'moments': {k: {n: t.clone() for n, t in zip(params, v)}
                    for k, v in state.opt_state.items()
                    if isinstance(v, list)},
        'buffers': {k: b.clone() for k, b in det.net.named_buffers()},
        'decisions': decisions(rec),
        'hyperparams': state.opt_state.get('hyperparams'),
    }


def to_tensors(batch):
    return {k: to_tensors(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in batch.items()}


def build(tcfg, total_steps=100):
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train import optim, state as st
    det = build_detector(tcfg, device='cpu')
    tx, _ = optim.build_optimizer(tcfg.OPTIMIZATION, total_steps)
    return det, tx, st.create_train_state(det, tx)


def _bn_modules(net):
    from glenet_tpu_torch.models.ddn_deeplab import BatchNorm
    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    return [(n, m) for n, m in net.named_modules()
            if isinstance(m, (MaskedBatchNorm, BatchNorm))]


@contextlib.contextmanager
def record_bn_outputs(net):
    """Every BN output of the step (each feeds a ReLU), per module."""
    rec = {}

    def hook(name):
        def fn(_mod, _inp, y):
            rec.setdefault(name, []).append(y.detach().clone())
        return fn

    handles = [m.register_forward_hook(hook(n))
               for n, m in _bn_modules(net)]
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def align_relu_kinks(net, record, rank, rel=1e-5):
    """A rank's BN outputs on the one-process step's side of 0 where the
    two lie on either side within rounding (a shift by less than rounding,
    the gradient path unchanged; torch_parity.align_relu_kinks's rule), so
    both differentiate one branch of each ReLU.  The rows of a BN output
    are sample-major: the rank's are its block of the record's.  Only an
    element whose two values both lie within `rel` of the module's largest
    |output| may flip; any other flip fails."""
    calls = {n: list(v) for n, v in (record or {}).items()}
    seen = {'flipped': 0}
    if record is None:
        yield seen
        return

    def hook(name):
        def fn(_mod, _inp, y):
            full = calls[name].pop(0)
            n = y.shape[0]
            ref = full[rank * n:(rank + 1) * n]
            flip = (y > 0) != (ref > 0)
            if not bool(flip.any()):
                return None
            eps = rel * float(full.abs().max())
            near = (y.abs() <= eps) & (ref.abs() <= eps)
            assert bool(near[flip].all()), (
                f'{name}: a ReLU input flips sign beyond rounding')
            seen['flipped'] += int(flip.sum())
            return y + torch.where(flip, ref - y, 0.0).detach()
        return fn

    handles = [m.register_forward_hook(hook(n))
               for n, m in _bn_modules(net)]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def split_bn_sums(world):
    """MaskedBatchNorm's moment sums taken over each of `world` blocks of
    rows and added in block order, as the data-parallel step's all-reduce
    adds the ranks' sums."""
    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    orig = MaskedBatchNorm.moment_sums

    def split(x32, mask, cdim):
        if cdim == 0:
            return orig(x32, mask, cdim)
        n = x32.shape[0] // world
        parts = [orig(x32[i * n:(i + 1) * n],
                      None if mask is None else mask[i * n:(i + 1) * n],
                      cdim) for i in range(world)]
        out = list(parts[0])
        for p in parts[1:]:
            out = [a + b for a, b in zip(out, p)]
        return tuple(out)

    MaskedBatchNorm.moment_sums = staticmethod(split)
    try:
        yield
    finally:
        MaskedBatchNorm.moment_sums = staticmethod(orig)


def reference_step(tcfg, weights, batch, world=2):
    """The one-process step on the whole global batch -> snapshot, with
    its BN outputs under 'bn_outputs' and, under 'noise', each gradient's
    move when only the BN sums are added rank by rank (split_bn_sums):
    the rounding of the sums' order, which some toy heads' BN backward
    magnifies past 2e-4 of a gradient's largest element."""
    from glenet_tpu_torch.train import state as st
    tb = to_tensors(batch)
    det, tx, state = build(tcfg)
    det.net.load_state_dict(weights)
    with split_bn_sums(world):
        st.make_train_step(det, tx)(state, tb)
    split = {k: p.grad.clone() for k, p in det.net.named_parameters()
             if p.grad is not None}
    det, tx, state = build(tcfg)
    det.net.load_state_dict(weights)
    with capture(det) as rec, record_bn_outputs(det.net) as bn:
        state, metrics = st.make_train_step(det, tx)(state, tb)
    snap = snapshot(det, state, metrics, rec)
    snap['noise'] = {k: float((split[k] - g).abs().max()) if k in split
                     else 0.0 for k, g in snap['grads'].items()}
    return dict(snap, bn_outputs=bn)


def gts_from_proposals(tcfg, weights, batch, n_gt=8,
                       gt_offset=(0.15,)):
    """gt boxes `gt_offset` off the first 4 train-mode proposals of each
    sample (a throwaway copy of the net: the forward moves the BN stats),
    label variances in [0.02, 0.3), as torch_parity.run_train_steps."""
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(tcfg, device='cpu')
    det.net.load_state_dict(copy.deepcopy(weights))
    tb = to_tensors(batch)
    with torch.no_grad():
        out = det.net(tb['points'], tb['points_mask'], train=True,
                      gt_boxes=tb['gt_boxes'], gt_mask=tb['gt_mask'],
                      generator=torch.Generator().manual_seed(0))
    rois = out['proposals']['rois'].numpy()
    valid = out['proposals']['roi_valid'].numpy()
    labels = out['proposals']['roi_labels'].numpy()
    b = rois.shape[0]
    gt = np.zeros((b, n_gt, 8), np.float32)
    gt_mask = np.zeros((b, n_gt), bool)
    for i in range(b):
        idx = np.flatnonzero(valid[i])[:4]
        gt[i, :len(idx), :7] = rois[i, idx]
        gt[i, :len(idx), :len(gt_offset)] += gt_offset
        gt[i, :len(idx), 7] = labels[i, idx]
        gt_mask[i, :len(idx)] = True
    unc = np.random.RandomState(11).uniform(0.02, 0.3, (b, n_gt, 7))
    return dict(batch, gt_boxes=gt, gt_mask=gt_mask,
                gt_uncertainty=unc.astype(np.float32))


def jax_drawn_weights(cfg, tcfg, batch):
    """The parity tests' start weights (torch_parity.random_variables over
    glenet_tpu's variable shapes) as the port's state dict."""
    import jax
    import jax.numpy as jnp

    import torch_parity as tp
    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    det = jax_build(cfg)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jax.tree.map(jnp.asarray, batch))
    tdet = build(tcfg)[0]
    load_jax_variables(tdet.net, tp.random_variables(shapes, seed=1))
    return tdet.net.state_dict()


def run_cases(cases, tmp_path, world=2):
    """The one-process reference of each case and the 2 ranks' steps ->
    {name: (reference, [rank snapshots])}."""
    refs = {name: reference_step(tcfg, weights, batch)
            for name, tcfg, weights, batch in cases}
    ranks = launch('dp_cases', world, {'cases': [
        (*case, refs[case[0]].pop('bn_outputs')) for case in cases]},
        tmp_path)
    return {name: (refs[name], [r[name] for r in ranks])
            for name in refs}


def assert_family(name, ref, ranks, two_stage=True):
    """Each rank's step against the reference (assert_step_equal on its
    row), and the ranks' parameters and BN statistics bit-equal."""
    from glenet_tpu_torch.train import optim
    lr, b1 = ref['hyperparams']
    if two_stage:
        assert ref['decisions']['out0.roi_targets.reg_valid_mask'].any(), \
            'fg rois expected'
    for r, got in enumerate(ranks):
        assert_step_equal(got, ref, lr, b1, optim.ADAM_B2,
                             rows=slice(r, r + 1), tag=f'{name} rank {r}')
    for k, v in ranks[0]['buffers'].items():
        assert torch.equal(v, ranks[1]['buffers'][k]), (name, k)
    for k, v in ranks[0]['params'].items():
        assert torch.equal(v, ranks[1]['params'][k]), (name, k)


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def _rank_state(tcfg, weights, rank):
    """Rank 0 holds `weights`, the others a build from another seed:
    put_replicated must make them equal."""
    torch.manual_seed(1000 + rank)
    det, tx, state = build(tcfg)
    if rank == 0:
        det.net.load_state_dict(weights)
    return det, tx, state


def dp_cases(rank, world, payload):
    """payload: {'cases': [(name, port cfg, weights, global batch, the
    reference's BN outputs)]} -> {name: snapshot of this rank after one
    data-parallel step, with the ReLU inputs it took on the reference's
    side of 0 under 'flipped'}."""
    from glenet_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh('cpu')
    out = {}
    for name, tcfg, weights, batch, bn in payload['cases']:
        det, tx, state = _rank_state(tcfg, weights, rank)
        mesh_lib.put_replicated(state)
        step = mesh_lib.make_dp_train_step(det, tx, mesh)
        local = mesh_lib.shard_batch(to_tensors(batch), mesh)
        with capture(det) as rec, align_relu_kinks(
                det.net, bn, mesh.get_local_rank(mesh_lib.DATA_AXIS)) \
                as seen:
            state, metrics = step(state, local)
        out[name] = dict(snapshot(det, state, metrics, rec),
                         flipped=seen['flipped'])
    return out


def dp_spans(rank, world, payload):
    """payload: {'cfg': port cfg, 'batch': global batch} -> the port's
    spans [(name, start, end)] of one data-parallel step of this rank under
    a CPU profiler."""
    from glenet_tpu_torch.parallel import mesh as mesh_lib
    from glenet_tpu_torch.utils import trace
    mesh = mesh_lib.make_mesh('cpu')
    det, tx, state = build(payload['cfg'])
    mesh_lib.put_replicated(state)
    step = mesh_lib.make_dp_train_step(det, tx, mesh)
    local = mesh_lib.shard_batch(to_tensors(payload['batch']), mesh)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, local)
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(trace.PREFIX)]


def dp_tp_case(rank, world, payload):
    """payload: {'case': (name, cfg, weights, batch, BN outputs), 'mp',
    'ckpt'} -> this rank's snapshot after one (data, model) step, taken
    after `gather`, with the parameter names it stored sharded and their
    local shapes under 'sharded'; rank 0 also writes the gathered state as
    a checkpoint into the directory payload['ckpt']."""
    from glenet_tpu_torch.parallel import mesh as mesh_lib
    from glenet_tpu_torch.train import checkpoint as ckpt_lib
    mesh = mesh_lib.make_mesh_2d(payload['mp'], 'cpu')
    _, tcfg, weights, batch, bn = payload['case']
    det, tx, state = _rank_state(tcfg, weights, rank)
    mesh_lib.put_replicated(state)
    step = mesh_lib.make_dp_tp_train_step(det, tx, mesh)
    step.shard(state)
    local = mesh_lib.shard_batch(to_tensors(batch), mesh)
    with capture(det) as rec, align_relu_kinks(
            det.net, bn, mesh.get_local_rank(mesh_lib.DATA_AXIS)):
        state, metrics = step(state, local)
    names = [k for k, _ in det.net.named_parameters()]
    sharded = {names[i]: tuple(p.shape) for i, p in
               enumerate(det.net.parameters()) if i in step.sharded}
    step.gather(state)
    snap = snapshot(det, state, metrics, rec)
    snap['sharded'] = sharded
    if rank == 0:
        ckpt_lib.save_checkpoint(ckpt_lib.checkpoint_state(state, 0, 1),
                                 payload['ckpt'], 0)
    return snap


def bn_modules(kind):
    """A BN module of each kind the step syncs, seeded: 'masked'
    (MaskedBatchNorm over (B, N, C) with a row mask), 'dense'
    (MaskedBatchNorm over (B, C, H, W)) and 'deeplab' (the DeepLabV3 depth
    network's BatchNorm over (B, C, H, W))."""
    from glenet_tpu_torch.models.ddn_deeplab import BatchNorm
    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    torch.manual_seed(5)
    m = {'masked': lambda: MaskedBatchNorm(8),
         'dense': lambda: MaskedBatchNorm(8, channel_dim=1),
         'deeplab': lambda: BatchNorm(8)}[kind]()
    with torch.no_grad():
        for p in m.parameters():
            p.uniform_(0.5, 1.5)
    return m


def bn_forward_backward(kind, x, mask, w):
    """(output, d x, d weight, d bias, running mean, running var) of one
    train-mode forward of bn_modules(kind) and the backward of sum(y * w)."""
    m = bn_modules(kind)
    x = x.clone().requires_grad_(True)
    y = m(x, mask, use_running_average=False) if kind == 'masked' else (
        m(x, use_running_average=False) if kind == 'dense' else
        m(x, train=True))
    (y * w).sum().backward()
    return [y.detach(), x.grad, m.weight.grad, m.bias.grad,
            m.running_mean.clone(), m.running_var.clone()]


def bn_case(rank, world, payload):
    """payload: {kind: (x, mask, w) of the global batch} -> {kind: the
    rank's bn_forward_backward on its rows inside data_parallel, with the
    parameter gradients summed over the ranks}."""
    import torch.distributed as dist

    from glenet_tpu_torch.parallel import distributed as dp
    out = {}
    for kind, (x, mask, w) in payload.items():
        n = x.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        with dp.data_parallel(dist.group.WORLD):
            res = bn_forward_backward(kind, x[rows], None if mask is None
                                      else mask[rows], w[rows])
        for g in res[2:4]:
            dist.all_reduce(g)
        out[kind] = res
    return out


def _main(function, rank, world, port, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    # f32 gathers and dense levels, as torch_parity.pinned_f32 in the
    # parent: bf16 rounding would turn the sums' rounding into 1e-3 steps
    from glenet_tpu_torch.models import spconv_backbone
    from glenet_tpu_torch.ops import sparse
    sparse.GATHER_COMPUTE_DTYPE = spconv_backbone.DENSE_MXU_DTYPE = None
    from glenet_tpu_torch.parallel import distributed
    distributed.initialize(f'127.0.0.1:{port}', world, rank, device='cpu',
                           timeout_s=300)
    payload = torch.load(Path(out_dir) / 'payload.pt', weights_only=False)
    result = globals()[function](rank, world, payload)
    torch.save(result, Path(out_dir) / f'rank{rank}.pt')
    distributed.shutdown()


# ---------------------------------------------------------------------------
# comparisons (tests/test_torch_train_step.py's tolerances)
# ---------------------------------------------------------------------------

def assert_metrics(got, ref, tag=''):
    assert set(got) == set(ref), (tag, set(got) ^ set(ref))
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=f'{tag} {k}')


def _grad_tol(g_ref):
    return 2e-4 * float(g_ref.abs().max()) + 1e-6


def assert_step_equal(got, ref, lr, b1, b2, rows=None, tag=''):
    """One rank's snapshot `got` against the one-process `ref`: loss
    terms, grad_norm, gradients, parameters after the update, optimizer
    moments and BN statistics within the tolerances above; every integer
    decision exactly, on the rank's `rows` of the global batch."""
    assert_metrics(got['metrics'], ref['metrics'], tag)
    n_tight = n_all = 0
    for k, g_ref in ref['grads'].items():
        g = got['grads'][k]
        tol = _grad_tol(g_ref) + 2 * ref['noise'][k]
        assert float((g - g_ref).abs().max()) <= tol, (tag, k)
        agree = (g - g_ref).abs() <= 1e-2 * g_ref.abs()
        diff = (got['params'][k] - ref['params'][k]).abs()
        if agree.any():
            assert float(diff[agree].max()) <= 1e-6, (tag, k)
        assert float(diff.max()) <= 2 * lr + 1e-6, (tag, k)
        n_tight += int(agree.sum())
        n_all += agree.numel()
        gmax = float(g_ref.abs().max())
        for name, scale, t in (('mu', 1 - b1, tol),
                               ('nu', 1 - b2, tol * (2 * gmax + tol))):
            if name in ref['moments']:
                m_diff = (got['moments'][name][k]
                          - ref['moments'][name][k]).abs().max()
                assert float(m_diff) <= scale * t + 1e-12, (tag, name, k)
    assert n_tight > 0.9 * n_all, tag
    for k, v in ref['buffers'].items():
        np.testing.assert_allclose(got['buffers'][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f'{tag} {k}')
    assert_decisions(got['decisions'], ref['decisions'], rows, tag)


def assert_decisions(got, ref, rows=None, tag=''):
    assert set(got) == set(ref), (tag, set(got) ^ set(ref))
    for k, v in ref.items():
        want = v if rows is None else v[rows]
        assert torch.equal(got[k], want), (tag, k)


if __name__ == '__main__':
    f, r, w, port, d = sys.argv[1:]
    _main(f, int(r), int(w), port, d)
