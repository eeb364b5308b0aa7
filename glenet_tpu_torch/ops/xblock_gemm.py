"""The x-block gather-GEMM: the contraction of every 3^3 sparse conv over an
x-block table, on CUDA tensors in the hand-written Hopper kernel
`csrc/xblock_gemm.cu`.

Replaces no TPU kernel: glenet_tpu's contraction is XLA-level `jnp`.  Its
plain PyTorch version, `ops/sparse.py::gather_gemm_xblocks_plain`, which
CPU tensors take, is bound by its intermediates on the H100 (a per-tap
operand 27 Cin wide per site, and its float32 copy); the kernel reads the
features, the table and the weights and writes the output, once each.  The
wrapper is kept lean, as `merge_kernel.py`'s: the C function is resolved
once, the output is one `torch.empty`, the stream is read without entering
a device context, and nothing waits for the device.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import cuda_lib

MAX_COUT = 128      # the kernel's widest output tile

_SIGNATURES = {
    'xblock_gemm': ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p], ctypes.c_int),
}
_launch = None      # the C function, resolved at the first launch


def check(features, q, tbl, weights):
    """Raise on arguments outside the contraction's contract: features
    (B, V, Cin) floating, q / tbl (B, 9, Vo) int32, weights (27, Cin, Cout)
    floating, all on one device."""
    if features.dim() != 3 or q.dim() != 3 or weights.dim() != 3:
        raise ValueError(f'features must be (B, V, Cin), q (B, 9, Vo) and '
                         f'weights (27, Cin, Cout); got '
                         f'{tuple(features.shape)}, {tuple(q.shape)}, '
                         f'{tuple(weights.shape)}')
    b, _, cin = features.shape
    if q.shape[0] != b or q.shape[1] != 9 or tbl.shape != q.shape:
        raise ValueError(f'q and tbl must both be ({b}, 9, Vo); got '
                         f'{tuple(q.shape)}, {tuple(tbl.shape)}')
    if weights.shape[:2] != (27, cin):
        raise ValueError(f'weights must be (27, {cin}, Cout); got '
                         f'{tuple(weights.shape)}')
    if q.dtype != torch.int32 or tbl.dtype != torch.int32:
        raise TypeError(f'q and tbl must be int32, got {q.dtype}, '
                        f'{tbl.dtype}')
    if not (features.is_floating_point() and weights.is_floating_point()):
        raise TypeError(f'features and weights must be floating, got '
                        f'{features.dtype}, {weights.dtype}')
    for name, t in (('q', q), ('tbl', tbl), ('weights', weights)):
        if t.device != features.device:
            raise ValueError(f'{name} on {t.device}, features on '
                             f'{features.device}')


def _load():
    global _launch
    _launch = cuda_lib.load('xblock_gemm', _SIGNATURES).xblock_gemm
    return _launch


def gather_gemm(features, q, tbl, weights, round_bf16: bool):
    """The contraction on checked CUDA tensors -> (B, Vo, Cout) float32:
    bf16 operands with float32 sums when `round_bf16`, float32 operands
    otherwise."""
    if not features.is_cuda:
        raise ValueError(f'unsupported device {features.device}')
    if features.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f'the kernel takes float32 features and weights, '
                        f'got {features.dtype}, {weights.dtype}')
    b, v, cin = features.shape
    vo, cout = q.shape[2], weights.shape[2]
    if cout > MAX_COUT:
        raise ValueError(f'Cout {cout} > {MAX_COUT}')
    fn = _launch or _load()
    features, q, tbl, weights = (t.contiguous() for t in
                                 (features, q, tbl, weights))
    out = torch.empty((b, vo, cout), dtype=torch.float32,
                      device=features.device)
    dev = features.get_device()
    args = (features.data_ptr(), q.data_ptr(), tbl.data_ptr(),
            weights.data_ptr(), out.data_ptr(), b, v, vo, cin, cout,
            int(round_bf16), torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f'xblock_gemm launch failed: CUDA error {err}')
    trace.count('xblock_gemm_launches')
    return out
