"""Process groups of the port (torch counterpart of
glenet_tpu/parallel/distributed.py) and the data-parallel context of the
train step.

  - `initialize()` starts torch.distributed from the CLIs' flags (JAX:
    jax.distributed.initialize): TCP rendezvous at the coordinator, NCCL
    for a CUDA device and gloo for the CPU unless the caller names a
    backend;
  - `get_dist_info()` -> (rank, world size), (0, 1) in one process;
  - `all_gather_objects` and `merge_results_dist`, the host-side result
    merge of the test CLI;
  - `barrier()`, `shutdown()`.

`data_parallel(group)` is on only while the data-parallel train step runs
(parallel/mesh.py): inside it the BN moments (`sum_moments`) and the
batch-global loss normalizers (`global_count`, `global_batch`) are summed
over the data group, so the ranks' losses add up to the loss of the whole
global batch, and the random draws of the step (`data_rows`) are those of
the global batch.  Outside it (predict, eval, the BN refresh, one process)
every helper is the identity.

There is no fallback: a rendezvous that fails raises, and a collective
that cannot run on the group's backend for the tensor's device raises
naming both.
"""
from __future__ import annotations

import contextlib
import datetime

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device='cuda', backend=None, timeout_s=DEFAULT_TIMEOUT_S):
    """Join the process group at `coordinator_address` (host:port) as rank
    `process_id` of `num_processes`; None is a no-op, as in JAX.  Returns
    the rank's device: `cuda:{process_id % device_count}` (set as the
    current device before any collective) or the CPU."""
    device = torch.device(device)
    if coordinator_address is None:
        return device
    if num_processes is None or process_id is None:
        raise ValueError('--coordinator_address needs --num_processes and '
                         '--process_id')
    if device.type == 'cuda':
        device = torch.device('cuda',
                              process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    dist.init_process_group(
        backend or ('nccl' if device.type == 'cuda' else 'gloo'),
        init_method=f'tcp://{coordinator_address}',
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def get_dist_info():
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def barrier():
    if get_dist_info()[1] > 1:
        dist.barrier()


def shutdown():
    """Wait for every rank, then leave the process group (a no-op without
    one)."""
    if dist.is_initialized():
        barrier()
        dist.destroy_process_group()


def collective(name, fn, tensor, group=None):
    """Run `fn` (a torch.distributed call on `tensor`); a backend that has
    no implementation for the tensor's device raises naming both."""
    try:
        return fn()
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f'{name} of a {tensor.device.type} tensor on the '
            f'{dist.get_backend(group)} backend failed: {e}') from e


def all_gather_objects(obj):
    """Every rank's picklable `obj`, in rank order."""
    world = get_dist_info()[1]
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def merge_results_dist(part_list, total_size: int):
    """Rank-ordered merge of per-process result lists truncated to
    total_size (semantics of common_utils.merge_results_dist)."""
    gathered = all_gather_objects(part_list)
    merged = []
    for results in zip(*gathered):
        merged.extend(results)
    # interleaved sampler order -> flatten; truncate wrap-padding
    flat = [x for part in gathered for x in part]
    return (flat[:total_size] if len(flat) >= total_size
            else merged[:total_size])


# ---------------------------------------------------------------------------
# the data-parallel context of the train step
# ---------------------------------------------------------------------------

_DATA_GROUP = None


@contextlib.contextmanager
def data_parallel(group):
    """Sum BN moments and loss normalizers over `group` (a process group of
    the ranks that split the global batch) while the context is open."""
    global _DATA_GROUP
    prev, _DATA_GROUP = _DATA_GROUP, group
    try:
        yield
    finally:
        _DATA_GROUP = prev


def data_rows():
    """(rank, world) of the open data group: this rank holds rows
    rank * B ... (rank + 1) * B - 1 of the global batch; (0, 1) outside."""
    if _DATA_GROUP is None:
        return 0, 1
    return dist.get_rank(_DATA_GROUP), dist.get_world_size(_DATA_GROUP)


def global_batch(batch_size: int) -> int:
    """The global batch size of a local one."""
    return batch_size * data_rows()[1]


def all_reduce_sum(t, group):
    """In-place SUM over `group`; raises naming the backend and device
    where the backend cannot."""
    collective('all_reduce', lambda: dist.all_reduce(t, group=group), t,
               group)
    return t


@torch.no_grad()
def global_count(t):
    """A count (or sum) over the local rows, summed over the data group,
    without a gradient: the normalizer of a batch-global mean."""
    if _DATA_GROUP is None:
        return t
    return all_reduce_sum(t.detach().clone(), _DATA_GROUP)


class _SumOverGroup(torch.autograd.Function):
    """all-reduce SUM forward; the backward sums the cotangents over the
    group too (each rank's loss depends on every rank's moments)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.group), None


def sum_moments(*tensors):
    """BN moment sums (tensors of any shapes) summed over the data group in
    one all-reduce, with their gradient; returned as given outside the
    data-parallel step."""
    if _DATA_GROUP is None:
        return tensors
    flat = _SumOverGroup.apply(torch.cat([t.reshape(-1) for t in tensors]),
                               _DATA_GROUP)
    return tuple(f.reshape(t.shape) for f, t in
                 zip(flat.split([t.numel() for t in tensors]), tensors))
