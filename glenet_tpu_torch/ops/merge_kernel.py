"""Merge-resolve: positions and successor deltas of SORTED queries in a
sorted per-sample id table, for the sparse-conv x-block table builds.

Replaces the Pallas TPU kernel `glenet_tpu/ops/merge_kernel.py::_kernel`
(reached through its `resolve_sorted_queries`).  On CUDA tensors the work
runs in the hand-written Hopper kernel `csrc/merge_resolve.cu`; on CPU
tensors in `resolve_sorted_queries_plain`, its plain PyTorch version.

What bounds it on the H100: bytes.  Per query the kernel reads 4 B and
writes 16 B, and the table reads of the binary search mostly hit the 50 MB
L2 (a level's table is at most ~0.6 MB per sample).  A full-width GLENet-VR
predict issues ~8.2 M queries over its four table builds, ~165 MB, which is
~0.05 ms at 3.35 TB/s (an estimate from the code; chip_smoke.py measures
it).  The design does nothing clever about it yet: one thread per query, a
lower-bound binary search, three bounds-checked successor reads, all index
arithmetic in 64 bits (the raw shifted queries may be negative or lie above
the sentinel).  Walking the sorted queries as a merge is later work.

Contract (same as the JAX function), per q = queries[b, g, j]:
    pos = left insertion index of q into ids[b]          (in [0, V])
    dk  = clamp(ids[b][pos + k] - q, 0, 3), k = 0, 1, 2  (3 past the table)
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

_POS_BITS = 20

# Launches of the CUDA kernel (not of the plain version); chip_smoke.py
# resets and reads it to show that the main path went through the kernel.
LAUNCHES = 0

_SIGNATURES = {
    'merge_resolve': ([ctypes.c_void_p] * 6
                      + [ctypes.c_longlong] * 3 + [ctypes.c_void_p],
                      ctypes.c_int),
}


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


def resolve_sorted_queries(ids, queries):
    """Positions + successor deltas of sorted queries in sorted tables.

    Args:
        ids: (B, V) int32, each row sorted ascending (sentinel padding at
            the end is fine), V < 2^20.
        queries: (B, G, Vq) int32, each [b, g] row sorted ascending.
    Returns:
        (pos, d0, d1, d2): each (B, G, Vq) int32.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version.
    """
    global LAUNCHES
    _check(ids, queries)
    if ids.device.type == 'cpu':
        return resolve_sorted_queries_plain(ids, queries)
    if ids.device.type != 'cuda':
        raise ValueError(f'unsupported device {ids.device}')
    if not (ids.is_contiguous() and queries.is_contiguous()):
        raise ValueError('ids and queries must be contiguous')
    lib = cuda_lib.load('merge_resolve', _SIGNATURES)
    b, v = ids.shape
    _, g, vq = queries.shape
    outs = [torch.empty((b, g, vq), dtype=torch.int32, device=ids.device)
            for _ in range(4)]
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.merge_resolve(ids.data_ptr(), queries.data_ptr(),
                                *(o.data_ptr() for o in outs),
                                b, v, g * vq, stream)
    if err != 0:
        raise RuntimeError(f'merge_resolve launch failed: CUDA error {err}')
    LAUNCHES += 1
    return tuple(outs)
