"""Merge-resolve: positions and successor deltas of SORTED queries in a
sorted per-sample id table, for the sparse-conv x-block table builds.

Replaces the Pallas TPU kernel `glenet_tpu/ops/merge_kernel.py::_kernel`
(reached through its `resolve_sorted_queries`).  On CUDA tensors the work
runs in the hand-written Hopper kernel `csrc/merge_resolve.cu`; on CPU
tensors in `resolve_sorted_queries_plain`, its plain PyTorch version.

What bounds it on the H100: bytes.  Per query the kernel reads 4 B and
writes 16 B; a full-width GLENet-VR predict issues ~8.2 M queries over its
four table builds, ~165 MB, ~0.05 ms at 3.35 TB/s.  A binary search per
query from scratch is bound by latency instead (a chain of ~17 dependent L2
loads), so the kernel uses that each [b, g] query row is sorted: a block
owns a tile of 1024 consecutive queries, bounds the tile's table window with
one warp-wide search, stages it in shared memory, each warp narrows it to
its own 128 queries, and each lane runs its 4 searches branch-free in
lockstep there.  Tiles whose window is wider than the shared buffer resolve
per warp, exactly, from a per-warp buffer or from global memory
(`resolve_sorted_queries_counted` counts them, as do the counters
`merge_wide_tiles` and `merge_global_groups` of utils/trace.py while
tracing is on, beside `merge_launches`).  The wrapper is kept lean,
since at these sizes the host's cost per call is of the kernel's order: the
C function is resolved once, the four outputs are one allocation, and the
stream is read without entering a device context.

Contract (same as the JAX function), per q = queries[b, g, j]:
    pos = left insertion index of q into ids[b]          (in [0, V])
    dk  = clamp(ids[b][pos + k] - q, 0, 3), k = 0, 1, 2  (3 past the table)
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import cuda_lib

_POS_BITS = 20
# the kernel's slow-path counts, as utils/trace.py counters
_STAT_NAMES = ('merge_wide_tiles', 'merge_global_groups')

_SIGNATURES = {
    'merge_resolve': ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
                      + [ctypes.c_void_p] * 2, ctypes.c_int),
}
_launch = None      # the C function, resolved at the first launch


def _check(ids, queries):
    if ids.dtype != torch.int32 or queries.dtype != torch.int32:
        raise TypeError(f'ids/queries must be int32, got {ids.dtype}, '
                        f'{queries.dtype}')
    if ids.dim() != 2 or queries.dim() != 3:
        raise ValueError(f'ids must be (B, V) and queries (B, G, Vq); got '
                         f'{tuple(ids.shape)}, {tuple(queries.shape)}')
    if queries.shape[0] != ids.shape[0]:
        raise ValueError('batch sizes of ids and queries differ')
    if ids.shape[1] >= (1 << _POS_BITS):
        raise ValueError(f'table of {ids.shape[1]} slots: V must be < 2^20')
    if ids.device != queries.device:
        raise ValueError(f'ids on {ids.device}, queries on {queries.device}')


def resolve_sorted_queries_plain(ids, queries):
    """The plain PyTorch version: torch.searchsorted, then clamped successor
    gathers.  Same contract and outputs as resolve_sorted_queries."""
    _check(ids, queries)
    b, v = ids.shape
    _, g, vq = queries.shape
    q = queries.reshape(b, g * vq).contiguous()
    pos = torch.searchsorted(ids.contiguous(), q, right=False)
    # 2^40 past the table: any int32 query is >= 3 below it
    ext = torch.cat([ids.long(),
                     torch.full((b, 3), 1 << 40, dtype=torch.int64,
                                device=ids.device)], dim=1)
    q64 = q.long()
    outs = [pos.to(torch.int32).reshape(b, g, vq)]
    for k in range(3):
        dk = (ext.gather(1, pos + k) - q64).clamp(0, 3)
        outs.append(dk.to(torch.int32).reshape(b, g, vq))
    return tuple(outs)


def _load():
    global _launch
    _launch = cuda_lib.load('merge_resolve', _SIGNATURES).merge_resolve
    return _launch


def _resolve_cuda(ids, queries, stats=None):
    """Launch the kernel on checked CUDA tensors; returns the four views of
    one (4, B, G, Vq) output.  `stats`: None, or a (2,) int32 tensor the
    kernel adds its two slow-path counts to; by default, while tracing,
    the counters merge_wide_tiles and merge_global_groups."""
    if not ids.is_cuda:
        raise ValueError(f'unsupported device {ids.device}')
    if not (ids.is_contiguous() and queries.is_contiguous()):
        raise ValueError('ids and queries must be contiguous')
    fn = _launch or _load()
    b, v = ids.shape
    _, g, vq = queries.shape
    out = ids.new_empty((4, b, g, vq))       # int32, on ids' device
    if stats is None:
        stats = trace.device_slots(_STAT_NAMES, ids.device)
    dev = ids.get_device()
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # several microseconds of host time per call
    args = (ids.data_ptr(), queries.data_ptr(), out.data_ptr(), b, g, v, vq,
            None if stats is None else stats.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f'merge_resolve launch failed: CUDA error {err}')
    trace.count('merge_launches')
    return out.unbind(0)


def resolve_sorted_queries(ids, queries):
    """Positions + successor deltas of sorted queries in sorted tables.

    Args:
        ids: (B, V) int32, each row sorted ascending (sentinel padding at
            the end is fine), V < 2^20.
        queries: (B, G, Vq) int32, each [b, g] row sorted ascending.
    Returns:
        (pos, d0, d1, d2): each (B, G, Vq) int32, contiguous.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version.
    """
    _check(ids, queries)
    if ids.device.type == 'cpu':
        return resolve_sorted_queries_plain(ids, queries)
    return _resolve_cuda(ids, queries)


def resolve_sorted_queries_counted(ids, queries):
    """resolve_sorted_queries on CUDA tensors, with two counts of the
    kernel's slow paths: tiles whose table window was wider than its shared
    buffer, and groups of 128 queries in them resolved from global memory.
    Returns ((pos, d0, d1, d2), wide_tiles, global_groups); synchronises to
    read the counts."""
    _check(ids, queries)
    stats = torch.zeros(2, dtype=torch.int32, device=ids.device)
    outs = _resolve_cuda(ids, queries, stats)
    wide, glob = stats.tolist()
    return outs, wide, glob
