"""Device meshes and the train steps across processes (torch counterpart of
glenet_tpu/parallel/mesh.py), one process per rank.

Data parallelism (`make_mesh`, `make_dp_train_step`): a 1-D ('data',)
mesh over every rank; rank r holds rows r*B ... (r+1)*B-1 of the global
batch (`shard_batch`) and the whole train state.  The step runs the
forward and backward inside distributed.data_parallel: the BN moments are
the global batch's (summed over the ranks with their gradient), the loss
normalizers are the global batch's, and the random draws are those the
one-process step makes for the rank's rows, so the ranks' losses add up to
the loss of the whole batch.  Their gradients are summed in one flat
buffer per dtype, and the clip and the optimizer then see the global
gradient, as XLA's all-reduce inside the jitted JAX step gives it.

Tensor parallelism (`make_mesh_2d`, `make_dp_tp_train_step`): a 2-D
('data', 'model') mesh, rank = d * mp + m.  `param_shardings` picks the
kernels glenet_tpu shards over 'model' (>= 2 dims and >= 4096 elements in
the JAX layout, the JAX last (output-channel) axis divisible by mp); each
'model' rank stores only its 1/mp output-channel slice of those and of
their optimizer moments.  The step all-gathers the full kernels within the
'model' group before the forward, sums the gradients over the 'data'
group, and updates each rank's own slice.  As in JAX the compute is not
split by channel: only the storage is sharded.

`put_replicated` broadcasts the parameters, the BN statistics and the
optimizer state from rank 0, as JAX assembles its replicated state from
identical per-host copies.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import init_device_mesh

from ..models.layers import ConvBlock
from ..models.spconv_backbone import InverseConvBN, SparseConvBN, SubMConvBN
from ..models.vector_pool import VectorPoolAggregation
from ..train import state as state_lib
from ..utils import trace
from ..utils.jax_weights import jax_path_and_shape
from . import distributed as dp

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


def make_mesh(device='cuda'):
    """('data',) mesh over every rank of the process group."""
    return init_device_mesh(torch.device(device).type,
                            (dist.get_world_size(),),
                            mesh_dim_names=(DATA_AXIS,))


def make_mesh_2d(mp: int = 2, device='cuda'):
    """(data, model) mesh: dp = world // mp."""
    n = dist.get_world_size()
    assert n % mp == 0, f'{n} ranks not divisible by mp={mp}'
    return init_device_mesh(torch.device(device).type, (n // mp, mp),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _out_axis(module) -> int:
    """The torch axis of a kernel's JAX output-channel (last) axis
    (utils/jax_weights.py's layouts)."""
    if isinstance(module, (nn.ConvTranspose2d, ConvBlock)):
        return 1
    if isinstance(module, (SubMConvBN, SparseConvBN, InverseConvBN,
                           VectorPoolAggregation)):
        return -1
    return 0             # Linear, Conv2d, DenseConvBN


def param_shardings(net: nn.Module, mp: int, min_size: int = 1 << 12):
    """{parameter name: the torch axis it is sharded on} for the kernels
    glenet_tpu.parallel.mesh.param_shardings shards over a 'model' axis of
    size mp; every other parameter is replicated."""
    out = {}
    for key, p in net.named_parameters():
        _, shape = jax_path_and_shape(net, key, tuple(p.shape))
        if len(shape) >= 2 and int(np.prod(shape)) >= min_size \
                and shape[-1] % mp == 0:
            module = net.get_submodule(key.rsplit('.', 1)[0])
            axis = _out_axis(module) % p.dim()
            assert p.shape[axis] == shape[-1], (key, p.shape, shape)
            out[key] = axis
    return out


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (tensors, arrays, lists and dicts
    of them, batch axis first)."""
    n = axis_size(mesh, DATA_AXIS)
    r = mesh.get_local_rank(DATA_AXIS)

    def rows(v):
        if isinstance(v, dict):
            return {k: rows(x) for k, x in v.items()}
        assert len(v) % n == 0, f'global batch {len(v)} over {n} ranks'
        b = len(v) // n
        return v[r * b:(r + 1) * b]

    return rows(batch)


def _coalesced(tensors, fn):
    """fn(flat) on one flat buffer per dtype, copied back into `tensors`;
    returns the bytes that went through fn."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    nbytes = 0
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        nbytes += flat.numel() * flat.element_size()
        for t, f in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(f.view_as(t))
    return nbytes


def _opt_lists(opt_state, n_params):
    """The optimizer's per-parameter tensor lists (Adam's mu and nu, SGD's
    trace)."""
    return {k: v for k, v in opt_state.items()
            if isinstance(v, list) and len(v) == n_params
            and all(torch.is_tensor(t) for t in v)}


@torch.no_grad()
def put_replicated(state: state_lib.TrainState):
    """Broadcast the parameters, buffers, optimizer state and step from
    rank 0 to every rank of the process group (in place; returns the
    state)."""
    tensors = list(state.net.parameters()) + list(state.net.buffers())
    n = len(list(state.net.parameters()))
    for ts in _opt_lists(state.opt_state, n).values():
        tensors += ts

    def bcast(flat):
        dp.collective('broadcast', lambda: dist.broadcast(flat, src=0),
                      flat)

    _coalesced(tensors, bcast)
    lists = _opt_lists(state.opt_state, n)
    rest = [state.step, {k: v for k, v in state.opt_state.items()
                         if k not in lists}]
    dist.broadcast_object_list(rest, src=0)
    state.step = rest[0]
    state.opt_state.update(rest[1])
    return state


class _StepBase:
    """Shared by the two steps: the forward and backward inside the data
    group's context, the gradient and metric sums over it."""

    def __init__(self, detector, tx, mesh, seed):
        self.detector, self.tx = detector, tx
        self.seed = seed
        self.data_group = mesh.get_group(DATA_AXIS)
        self.device = detector.device
        # per step: bytes of the gradient sum (its time: the
        # glenet::grad_allreduce span, utils/trace.py)
        self.stats = {}

    def _loss_and_grads(self, state, batch):
        with dp.data_parallel(self.data_group):
            params, grads, metrics = state_lib.loss_and_grads(
                self.detector, state, batch, self.seed)
        with trace.span('grad_allreduce'):
            self.stats['grad_bytes'] = _coalesced(
                grads, lambda flat: dp.all_reduce_sum(flat, self.data_group))
        for p, g in zip(params, grads):
            p.grad = g
        names = sorted(metrics)
        total = dp.all_reduce_sum(torch.stack([metrics[k] for k in names]),
                                  self.data_group)
        return params, grads, dict(zip(names, total.unbind()))


class DataParallelTrainStep(_StepBase):
    """train_step(state, batch) -> (state, metrics) of one rank on a
    ('data',) mesh: `batch` holds the rank's rows; metrics are the global
    batch's loss terms and grad_norm."""

    def __call__(self, state, batch):
        with trace.call_span('train_step'):
            params, grads, metrics = self._loss_and_grads(state, batch)
            with trace.span('optim'):
                metrics['grad_norm'] = self.tx.update(params, grads,
                                                      state.opt_state)
        state.step += 1
        return state, metrics


class DpTpTrainStep(_StepBase):
    """train_step(state, batch) -> (state, metrics) of one rank on a
    (data, model) mesh.  Between steps the sharded parameters and their
    optimizer moments hold the rank's slice (`shard`); `gather` puts the
    full tensors back (on every rank), e.g. for a checkpoint."""

    def __init__(self, detector, tx, mesh, seed):
        super().__init__(detector, tx, mesh, seed)
        self.mp = axis_size(mesh, MODEL_AXIS)
        self.m = mesh.get_local_rank(MODEL_AXIS)
        self.model_group = mesh.get_group(MODEL_AXIS)
        names = [k for k, _ in detector.net.named_parameters()]
        axes = param_shardings(detector.net, self.mp)
        # parameter index -> torch axis of its sharded dim
        self.sharded = {i: axes[k] for i, k in enumerate(names) if k in axes}

    def _slice(self, t, axis):
        return t.chunk(self.mp, axis)[self.m].contiguous()

    def _all_gather(self, t, axis):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.mp)]
        dp.collective('all_gather', lambda: dist.all_gather(
            parts, t, group=self.model_group), t, self.model_group)
        return torch.cat(parts, axis)

    def _per_param(self, state):
        params = list(state.net.parameters())
        lists = _opt_lists(state.opt_state, len(params))
        return params, lists

    @torch.no_grad()
    def shard(self, state):
        """Keep the rank's slice of each sharded parameter and of its
        optimizer moments."""
        params, lists = self._per_param(state)
        for i, axis in self.sharded.items():
            params[i].data = self._slice(params[i].data, axis)
            for ts in lists.values():
                ts[i] = self._slice(ts[i], axis)
        return state

    @torch.no_grad()
    def gather(self, state, params_only=False):
        """Full tensors on every rank: the parameters and, unless
        params_only, their gradients and optimizer moments."""
        params, lists = self._per_param(state)
        for i, axis in self.sharded.items():
            p = params[i]
            p.data = self._all_gather(p.data, axis)
            if params_only:
                continue
            if p.grad is not None:
                p.grad = self._all_gather(p.grad, axis)
            for ts in lists.values():
                ts[i] = self._all_gather(ts[i], axis)
        return state

    def __call__(self, state, batch):
        with trace.call_span('train_step'):
            self.gather(state, params_only=True)
            params, grads, metrics = self._loss_and_grads(state, batch)
            with torch.no_grad():
                rep = [g for i, g in enumerate(grads) if i not in self.sharded]
                for i, axis in self.sharded.items():
                    grads[i] = self._slice(grads[i], axis)
                    params[i].data = self._slice(params[i].data, axis)
                    params[i].grad = grads[i]
                # each replicated leaf once, the sharded ones summed over the
                # slices of the 'model' group
                sq_sh = torch.zeros(1, device=self.device)
                for i in self.sharded:
                    sq_sh += grads[i].float().square().sum()
                dp.all_reduce_sum(sq_sh, self.model_group)
                sq_rep = sum(g.float().square().sum() for g in rep)
                norm = torch.sqrt(sq_rep + sq_sh[0])
            with trace.span('optim'):
                metrics['grad_norm'] = self.tx.update(
                    params, grads, state.opt_state, norm=norm)
        state.step += 1
        return state, metrics


def make_dp_train_step(detector, tx, mesh, seed: int = state_lib.SEED):
    """The data-parallel step (JAX: jit_train_step on a 1-D mesh)."""
    return DataParallelTrainStep(detector, tx, mesh, seed)


def make_dp_tp_train_step(detector, tx, mesh, seed: int = state_lib.SEED):
    """The (data, model) step (JAX: jit_train_step_2d with
    param_shardings)."""
    return DpTpTrainStep(detector, tx, mesh, seed)
