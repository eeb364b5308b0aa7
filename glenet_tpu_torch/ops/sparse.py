"""Sparse 3D convolution primitives, main-path subset (torch counterpart of
glenet_tpu/ops/sparse.py).

A sparse tensor is (features (B, V, C), ids (B, V) int32, mask (B, V)):
`ids` are linearized (z, y, x) coordinates, SORTED ascending per sample,
invalid slots holding the sentinel `n_cells` (so they sort last).

Neighbour tables are x-block tables: linear ids are x-minor, so for each
(dz, dy) offset group the three x taps hit three CONSECUTIVE ids, which sit
in consecutive slots of the sorted table.  The table builds resolve the
sorted query stream of each group with the merge-resolve kernel
(ops/merge_kernel.py) — always in the kernel-path form of the JAX package:
raw shifted queries, no sentinel substitution (that would break the
sortedness); spurious hits at out-of-range taps are masked by `valid_c`.
The contraction over an x-block table runs on the card in the x-block
gather-GEMM kernel (ops/xblock_gemm.py), on the CPU in its plain version
`gather_gemm_xblocks_plain`.

Convolutions off the x-block form (the (3, 1, 1) strided conv_out of UNetV2
and the inverse convs of its decoder) use row tables, (K, Vout) slots with
V_in as the padding row, from `strided_gather_table` / `inverse_gather_table`
and contract through `gather_gemm_b`.  Their queries are not monotone, so
the tables look them up with `torch.searchsorted` over the sorted id row
(the JAX package's merged-sort path), not with the merge-resolve kernel.
"""
from __future__ import annotations

import torch

from ..utils import trace
from . import merge_kernel, xblock_gemm

# Compute dtype of the gather + tap contraction (glenet_tpu's
# GATHER_COMPUTE_DTYPE): bf16 gathers and bf16 operands, contracted with an
# f32 result (_contract) that is cast back to the features' dtype.  None
# keeps full f32 (parity tests).
GATHER_COMPUTE_DTYPE = torch.bfloat16


def _as3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def kernel_offsets(kernel_size):
    """(K, 3) integer (z, y, x) offsets, row-major tap index."""
    kz, ky, kx = _as3(kernel_size)
    dz, dy, dx = torch.meshgrid(torch.arange(kz), torch.arange(ky),
                                torch.arange(kx), indexing='ij')
    return torch.stack([dz.reshape(-1), dy.reshape(-1), dx.reshape(-1)], 1)


def linearize(z, y, x, grid):
    nx, ny, nz = grid
    return z * (ny * nx) + y * nx + x


def delinearize(ids, grid):
    nx, ny, nz = grid
    z = ids // (ny * nx)
    rem = ids % (ny * nx)
    return z, rem // nx, rem % nx


def out_grid_size(grid, kernel_size, stride, padding):
    """Output (nx, ny, nz) for a strided sparse conv (conv arithmetic)."""
    kz, ky, kx = _as3(kernel_size)
    sz, sy, sx = _as3(stride)
    pz, py, px = _as3(padding)
    nx, ny, nz = grid
    return ((nx + 2 * px - kx) // sx + 1, (ny + 2 * py - ky) // sy + 1,
            (nz + 2 * pz - kz) // sz + 1)


def _group_offsets(lo, device):
    """(9, 2) (dz, dy) offsets of the x-block groups, dz-major."""
    r = torch.arange(lo, lo + 3, device=device)
    dz, dy = torch.meshgrid(r, r, indexing='ij')
    return torch.stack([dz.reshape(-1), dy.reshape(-1)], dim=1)


def _check_grid(max_query, grid):
    if max_query >= (1 << 28):
        raise ValueError(f'grid {grid} too large for the x-block tables')


def _xblock_hits(d0, d1, d2, valid_c, xok):
    """Per-tap hit masks and raw-membership ranks, packed into one int32
    plane: bit d (d = 0..2) is tap d's hit, bits 3/4 the RAW table membership
    of expected ids base+0 / base+1 (they rank gathered block rows to taps).

    d0/d1/d2: clamp(ids[pos + k] - base, 0, 3) — membership of base + d is
    any delta == d.  valid_c (..., 9, V) bool; xok: 3 masks (..., 1, V)
    broadcastable against it.
    """
    def member(d):
        return (d0 == d) | (d1 == d) | (d2 == d)

    m0, m1, m2 = member(0), member(1), member(2)
    i32 = torch.int32
    return ((m0 & valid_c & xok[0]).to(i32)
            | (m1 & valid_c & xok[1]).to(i32) << 1
            | (m2 & valid_c & xok[2]).to(i32) << 2
            | m0.to(i32) << 3
            | m1.to(i32) << 4)


def subm_xblock_table_b(ids, mask, grid):
    """x-block neighbour table of a 3^3 submanifold conv.

    ids/mask (B, V) -> q/tbl (B, 9, V): q the slot of the first table id
    >= base (clipped into the table), tbl as in _xblock_hits.
    """
    nx, ny, nz = grid
    # the raw shifted queries stay within the bound the JAX kernel path
    # asserts (its pad value 2^28)
    _check_grid(nx * ny * nz + ny * nx + nx, grid)
    v = ids.shape[1]
    d = _group_offsets(-1, ids.device)                            # (9, 2)
    shifts = (d[:, 0] * (ny * nx) + d[:, 1] * nx - 1).to(torch.int32)
    base_raw = ids[:, None, :] + shifts[None, :, None]            # (B,9,V)
    pos, d0, d1, d2 = merge_kernel.resolve_sorted_queries(
        ids.contiguous(), base_raw.contiguous())
    q = pos.clamp(0, v - 1)

    z, y, x = delinearize(torch.where(mask, ids, 0), grid)        # (B, V)
    tz = z[:, None, :] + d[None, :, 0:1]
    ty = y[:, None, :] + d[None, :, 1:2]
    valid_c = (mask[:, None, :]
               & (tz >= 0) & (tz < nz) & (ty >= 0) & (ty < ny))   # (B,9,V)
    xok = ((x - 1 >= 0)[:, None], torch.ones_like(mask)[:, None],
           (x + 1 < nx)[:, None])
    return q, _xblock_hits(d0, d1, d2, valid_c, xok)


def strided_xblock_table_b(in_ids, in_mask, out_ids, out_mask, grid,
                           stride, padding):
    """x-block gather table of a strided 3^3 sparse conv: for output site o
    and (dz, dy) group the three x taps read input ids base + {0, 1, 2},
    base = linearize(oz*s - p + dz, oy*s - p + dy, ox*s - p).  The raw query
    stream is monotone in the sorted out_ids (each axis map is affine
    increasing and cannot carry into the next axis)."""
    sz, sy, sx = _as3(stride)
    pz, py, px = _as3(padding)
    nx, ny, nz = grid
    _check_grid((nz + 4) * ny * nx, grid)
    onx, ony, onz = out_grid_size(grid, 3, stride, padding)
    v_in = in_ids.shape[1]

    oz_r = out_ids // (ony * onx)
    rem = out_ids % (ony * onx)
    oy_r, ox_r = rem // onx, rem % onx                            # (B, Vo)
    d = _group_offsets(0, out_ids.device)                         # (9, 2)
    iz_r = oz_r[:, None, :] * sz - pz + d[None, :, 0:1]           # (B,9,Vo)
    iy_r = oy_r[:, None, :] * sy - py + d[None, :, 1:2]
    ix0_r = ox_r * sx - px                                        # (B, Vo)
    base_raw = (iz_r * (ny * nx) + iy_r * nx + ix0_r[:, None, :])
    pos, d0, d1, d2 = merge_kernel.resolve_sorted_queries(
        in_ids.contiguous(), base_raw.to(torch.int32).contiguous())
    q = pos.clamp(0, v_in - 1)

    oz = torch.where(out_mask, oz_r, 0)
    oy = torch.where(out_mask, oy_r, 0)
    ox = torch.where(out_mask, ox_r, 0)
    iz = oz[:, None, :] * sz - pz + d[None, :, 0:1]
    iy = oy[:, None, :] * sy - py + d[None, :, 1:2]
    ix0 = (ox * sx - px)[:, None]
    valid_c = (out_mask[:, None, :]
               & (iz >= 0) & (iz < nz) & (iy >= 0) & (iy < ny))
    xok = ((ix0 >= 0) & (ix0 < nx), (ix0 + 1 >= 0) & (ix0 + 1 < nx),
           (ix0 + 2 >= 0) & (ix0 + 2 < nx))
    return q, _xblock_hits(d0, d1, d2, valid_c, xok)


def _gather_dtype(features):
    if GATHER_COMPUTE_DTYPE is not None and features.dtype == torch.float32:
        return GATHER_COMPUTE_DTYPE
    return features.dtype


def _take_rows_merged(ext, q):
    """ext (B, N, C); q (B, ...) row ids in [0, N) -> (B, ..., C): one flat
    row gather over the batch-merged operand."""
    b, n, c = ext.shape
    off = (torch.arange(b, device=q.device) * n).reshape(
        (b,) + (1,) * (q.dim() - 1))
    flat = ext.reshape(b * n, c).index_select(0, (q.long() + off).reshape(-1))
    return flat.reshape(*q.shape, c)


def _xblock_per_tap_b(features, q, tbl):
    """Gather half of the x-block contraction: features (B, V, Cin), q/tbl
    (B, 9, Vo) -> (B, 9, Vo, 3*Cin) per-tap operand in the gather compute
    dtype, zeros at tap misses.

    Block row t holds expected id base+d iff t equals the count of present
    ids among {base, ..., base+d-1} (the table is sorted unique and q is the
    left insertion point of base), so tap d selects row m0+...+m(d-1).
    """
    b, v, cin = features.shape
    gdtype = _gather_dtype(features)
    ext = torch.cat([features, features.new_zeros((b, 3, cin))],
                    dim=1).to(gdtype)
    ext3 = torch.cat([ext[:, :-2], ext[:, 1:-1], ext[:, 2:]], dim=-1)
    blocks = _take_rows_merged(ext3, q)                  # (B, 9, Vo, 3*Cin)
    b0, b1, b2 = blocks.split(cin, dim=-1)
    hit0 = ((tbl & 1) > 0)[..., None]
    hit1 = ((tbl & 2) > 0)[..., None]
    hit2 = ((tbl & 4) > 0)[..., None]
    m0 = ((tbl & 8) > 0)[..., None]
    n01 = (((tbl >> 3) & 1) + ((tbl >> 4) & 1))[..., None]
    zero = torch.zeros((), dtype=gdtype, device=features.device)
    pt0 = torch.where(hit0, b0, zero)
    pt1 = torch.where(hit1, torch.where(m0, b1, b0), zero)
    row2 = torch.where(n01 == 2, b2, torch.where(n01 == 1, b1, b0))
    pt2 = torch.where(hit2, row2, zero)
    return torch.cat([pt0, pt1, pt2], dim=-1)


def _contract(equation, a, b):
    """einsum of two gather-dtype operands with an f32 result, as the JAX
    package's preferred_element_type=float32: products of bf16 values are
    exact in f32 (and in TF32), so only the summation order differs."""
    return torch.einsum(equation, a.float(), b.float())


def gather_gemm_xblocks_plain(features, q, tbl, weights):
    """The plain PyTorch version of the x-block contraction: features
    (B, V, Cin), q/tbl (B, 9, Vo), weights (27, Cin, Cout) in (dz, dy)-major
    dx-minor tap order -> (B, Vo, Cout) in the features' dtype.  CPU tensors
    take it; the card runs ops/xblock_gemm.py's kernel."""
    cin = features.shape[-1]
    g = q.shape[1]
    gdtype = _gather_dtype(features)
    per_tap = _xblock_per_tap_b(features, q, tbl)
    w = weights.reshape(g, 3 * cin, -1).to(gdtype)
    return _contract('bgvk,gko->bvo', per_tap, w).to(features.dtype)


def _xblock_contract(features, q, tbl, weights):
    """The x-block contraction with no autograd: the kernel on CUDA tensors
    (or raise), the plain version on CPU tensors."""
    xblock_gemm.check(features, q, tbl, weights)
    if features.device.type == 'cpu':
        return gather_gemm_xblocks_plain(features, q, tbl, weights)
    gdtype = _gather_dtype(features)
    if gdtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'the kernel takes bf16 or float32 operands, not '
                        f'{gdtype}')
    return xblock_gemm.gather_gemm(features, q, tbl, weights,
                                   gdtype == torch.bfloat16)


class _GradientAt(torch.autograd.Function):
    """A zero scalar whose gradient at `x` is `grad`: it feeds a gradient
    into a graph without grad_outputs, which would have torch import
    torch.fx's symbolic shapes (sympy) at its first use, seconds of a
    run's set-up."""

    @staticmethod
    def forward(ctx, x, grad):
        ctx.save_for_backward(grad)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return ctx.saved_tensors[0], None


class _XBlockGatherGemm(torch.autograd.Function):
    """gather_gemm_xblocks_b of a STRIDED conv (in and out sites differ).
    It saves only its inputs; the backward rebuilds the per-tap operand
    and takes the plain composition's gradients (the JAX package's default
    AD there) without its forward product:

        d_per_tap = g @ W^T        d_weights = per_tap^T @ g

    float32 products of the operands, each rounded to its operand's dtype
    as autograd rounds it; the row gathers of per_tap carry d_per_tap back
    to the features as index_add_ scatters."""

    @staticmethod
    def forward(ctx, features, q, tbl, weights):
        ctx.save_for_backward(features, q, tbl, weights)
        return _xblock_contract(features, q, tbl, weights)

    @staticmethod
    def backward(ctx, g):
        features, q, tbl, weights = ctx.saved_tensors
        want = ctx.needs_input_grad
        b, n_g, vo = q.shape
        k = 3 * features.shape[-1]
        g2 = g.float().reshape(b * vo, -1)                  # (B Vo, Cout)
        with torch.enable_grad():
            f = features.detach().requires_grad_(want[0])
            w = weights.detach().requires_grad_(want[3])
            per_tap = _xblock_per_tap_b(f, q, tbl)          # (B, 9, Vo, K)
            wg = w.reshape(n_g, k, -1).to(per_tap.dtype)
            fed = []
            if want[0]:
                d_per_tap = torch.empty_like(per_tap)
                for i in range(n_g):
                    d_per_tap[:, i] = (g2 @ wg[i].detach().float().T).view(
                        b, vo, k)
                fed.append(_GradientAt.apply(per_tap, d_per_tap))
            if want[3]:
                # the sites' rows (B Vo, 9 K): one product over every site
                rows = torch.empty((b, vo, n_g, k), dtype=torch.float32,
                                   device=g.device)
                rows.copy_(per_tap.detach().transpose(1, 2))
                d_wg = (rows.reshape(b * vo, -1).T @ g2).to(wg.dtype)
                del rows
                fed.append(_GradientAt.apply(wg, d_wg.view(wg.shape)))
            obj = sum(fed)
        inputs = [t for t in (f, w) if t.requires_grad]
        grads = iter(torch.autograd.grad(obj, inputs))
        return (next(grads) if want[0] else None, None, None,
                next(grads) if want[3] else None)


def gather_gemm_xblocks_b(features, q, tbl, weights):
    """Sparse-conv contraction over an x-block table: features (B, V, Cin),
    q/tbl (B, 9, Vo), weights (27, Cin, Cout) in (dz, dy)-major dx-minor tap
    order -> (B, Vo, Cout) in the features' dtype.  Differentiable, with
    the backward of _XBlockGatherGemm."""
    return _XBlockGatherGemm.apply(features, q, tbl, weights)


def flip_tap_weights(weights):
    """Transpose-conv weights of a (K, Cin, Cout) tap-major kernel: tap k ->
    K-1-k (the offset negated in the row-major centred tap order), channel
    axes swapped -> (K, Cout, Cin)."""
    return weights.flip(0).transpose(1, 2)


class _SubmGatherGemm(torch.autograd.Function):
    """gather_gemm_xblocks_b of a SUBMANIFOLD conv with a gather-only
    backward (the JAX package's custom VJP).  In and out sites are the same
    table, so the transpose conv runs over the same (q, tbl) with the taps
    flipped: output row o reads input i = o + off_t exactly when input row i
    reads o = i + off_flip(t), and both hits mean "both sites active".

        d_features = the contraction of (g, q, tbl, flip_tap_weights(W))
        d_weights  = per_tap(features)^T @ g

    Two gather passes and no scatter; the saved q and tbl mean the backward
    builds no table and launches no merge-resolve kernel.  The forward and
    d_features run in the x-block kernel on the card."""

    @staticmethod
    def forward(ctx, features, q, tbl, weights):
        ctx.save_for_backward(features, q, tbl, weights)
        return _xblock_contract(features, q, tbl, weights)

    @staticmethod
    def backward(ctx, g):
        features, q, tbl, weights = ctx.saved_tensors
        cin = features.shape[-1]
        d_features = d_weights = None
        if ctx.needs_input_grad[0]:
            d_features = _xblock_contract(g.to(features.dtype), q, tbl,
                                          flip_tap_weights(weights))
        if ctx.needs_input_grad[3]:
            per_tap = _xblock_per_tap_b(features, q, tbl)   # (B, 9, V, 3Cin)
            d_weights = _contract('bgvk,bvo->gko', per_tap,
                                  g.to(per_tap.dtype))
            d_weights = d_weights.reshape(q.shape[1] * 3, cin, -1).to(
                weights.dtype)
        return d_features, None, None, d_weights


def subm_gather_gemm_xblocks_b(features, q, tbl, weights):
    """gather_gemm_xblocks_b for a submanifold conv (in and out sites share
    the table), with the gather-only backward of _SubmGatherGemm."""
    return _SubmGatherGemm.apply(features, q, tbl, weights)


def strided_output_sites(ids, mask, grid, kernel_size, stride, padding,
                         out_cap: int):
    """Active output sites of a strided sparse conv (spconv rule: output o is
    active iff some input i = o * s - p + k).  Per sample: ids/mask (V,).

    Per dimension only ceil(k/s) outputs can cover an input, so a 3^3
    stride-2 conv has at most 8 candidates per input.  When actives exceed
    `out_cap`, sites are dropped by UNIFORM RANK DECIMATION in sorted-id
    order (keep a site when floor(rank * cap / n) advances).

    Returns out_ids (out_cap,) int32 sorted (sentinel n_out_cells in empty
    slots) and out_mask (out_cap,) bool.
    """
    kz, ky, kx = _as3(kernel_size)
    sz, sy, sx = _as3(stride)
    pz, py, px = _as3(padding)
    onx, ony, onz = out_grid_size(grid, kernel_size, stride, padding)
    n_out_cells = onx * ony * onz
    dev = ids.device

    z, y, x = delinearize(torch.where(mask, ids, 0).long(), grid)

    def dim_cands(i, p, s, k, on):
        base = torch.div(i + p, s, rounding_mode='floor')
        rem = (i + p) - base * s
        out = []
        for dd in range(-(-k // s)):
            o = base - dd
            out.append((o, (rem + s * dd < k) & (o >= 0) & (o < on)))
        return out

    cand = []
    for oz, vz in dim_cands(z, pz, sz, kz, onz):
        for oy, vy in dim_cands(y, py, sy, ky, ony):
            for ox, vx in dim_cands(x, px, sx, kx, onx):
                ok = mask & vz & vy & vx
                cand.append(torch.where(ok, oz * (ony * onx) + oy * onx + ox,
                                        n_out_cells))
    srt = torch.sort(torch.stack(cand).reshape(-1)).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    first &= srt < n_out_cells
    rank = torch.cumsum(first.long(), 0) - 1
    n_active = (rank[-1] + 1).clamp_min(0)
    # f32 is exact for rank < 2^24 and ratio == 1.0 when n <= cap.  A true
    # f32 division, as the JAX package's: `out_cap / tensor` would multiply
    # by the reciprocal, which rounds differently and moves sites
    cap = torch.tensor(out_cap, dtype=torch.float32, device=dev)
    trace.count('host_waits')           # a pageable host-to-device copy
    ratio = cap / torch.maximum(n_active.to(torch.float32), cap)
    pos = torch.floor(rank.to(torch.float32) * ratio).long()
    pos = pos.clamp(0, out_cap - 1)
    prev = torch.floor((rank - 1).to(torch.float32) * ratio).long()
    keep = first & ((rank == 0) | (pos > prev))
    if trace.enabled():     # active sites against the level's cap
        level = f'{onx}x{ony}x{onz}'
        trace.count(f'sites_active.{level}', n_active)
        trace.count(f'sites_kept.{level}', keep)
    # kept sites have unique slots; the rest go to the dump slot out_cap
    out_ids = torch.full((out_cap + 1,), n_out_cells, dtype=torch.int64,
                         device=dev)
    out_ids[torch.where(keep, pos, out_cap)] = torch.where(keep, srt,
                                                           n_out_cells)
    out_ids = out_ids[:out_cap].to(torch.int32)
    return out_ids, out_ids < n_out_cells


# Per-level dilation multipliers of the voxel budget (glenet_tpu's measured
# KITTI-scale active-site growth at levels 2/3/4, plus margin).
LEVEL_CAP_MULTIPLIERS = (1.0, 3.3, 3.8, 2.1)


def level_caps(max_voxels: int):
    """Static active-site budgets for backbone levels 1..4 (strides
    1/2/4/8)."""
    return tuple(int(m * max_voxels) for m in LEVEL_CAP_MULTIPLIERS)


def to_dense_expand(features, ids, mask, grid, out_dtype=None):
    """Batched sorted-sparse rows -> dense canvases.

    Args: features (B, V, C); ids (B, V) sorted (n_cells sentinel in invalid
    slots); mask (B, V); grid (nx, ny, nz).
    Returns: dense (B, nz, ny, nx, C) in out_dtype (features.dtype if None),
    occ (B, nz, ny, nx) bool.

    The JAX package expands the row table through an occupancy cumsum to
    avoid a slow TPU row scatter; on the GPU one row scatter into a canvas
    with a dump row is the direct form: valid ids are unique, invalid rows
    all land in the dump row, which is cut off.  Its autograd is the JAX
    package's custom VJP: a gather of the canvas gradient at each row's
    cell, zero at masked rows (they read the cut-off dump row and are
    zeroed by the `where`).
    """
    nx, ny, nz = grid
    n_cells = nz * ny * nx
    b, v, c = features.shape
    dt = out_dtype or features.dtype
    flat = (torch.where(mask, ids, n_cells).long()
            + torch.arange(b, device=ids.device)[:, None] * (n_cells + 1))
    flat = flat.reshape(-1)
    dense = features.new_zeros((b * (n_cells + 1), c), dtype=dt)
    rows = torch.where(mask[..., None], features, 0).to(dt)
    dense[flat] = rows.reshape(-1, c)
    occ = torch.zeros(b * (n_cells + 1), dtype=torch.bool, device=ids.device)
    occ[flat] = True
    trace.count('host_waits')           # the value True copied to the card
    dense = dense.reshape(b, n_cells + 1, c)[:, :n_cells]
    occ = occ.reshape(b, n_cells + 1)[:, :n_cells]
    return dense.reshape(b, nz, ny, nx, c), occ.reshape(b, nz, ny, nx)


def _lookup(ids, tid, n_cells):
    """Slots of the queries `tid` (K, Vq) in the sorted id row `ids` (V,),
    V (the padding row) where absent or tid >= n_cells (the sentinel of an
    invalid tap)."""
    v = ids.shape[0]
    pos = torch.searchsorted(ids, tid.to(ids.dtype).contiguous())
    hit = ids[pos.clamp_max(v - 1)] == tid
    return torch.where(hit & (pos < v) & (tid < n_cells), pos,
                       v).to(torch.int32)


def strided_gather_table(in_ids, in_mask, out_ids, out_mask, grid,
                         kernel_size, stride, padding):
    """For each output site and kernel tap of a strided sparse conv, the
    input slot to gather (input coord = out * s - p + k).  Per sample:
    in_ids / in_mask (V_in,), out_ids / out_mask (Vout,) -> (K, Vout)
    int32 slots with V_in as the padding row."""
    sz, sy, sx = _as3(stride)
    pz, py, px = _as3(padding)
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    onx, ony, onz = out_grid_size(grid, kernel_size, stride, padding)
    oz = out_ids // (ony * onx)
    rem = out_ids % (ony * onx)
    oy, ox = rem // onx, rem % onx
    offs = kernel_offsets(kernel_size).to(out_ids.device)
    iz = oz[None, :] * sz - pz + offs[:, 0:1]
    iy = oy[None, :] * sy - py + offs[:, 1:2]
    ix = ox[None, :] * sx - px + offs[:, 2:3]
    valid = (out_mask[None, :] & (iz >= 0) & (iz < nz) & (iy >= 0)
             & (iy < ny) & (ix >= 0) & (ix < nx))
    tid = torch.where(valid, linearize(iz, iy, ix, grid), n_cells)
    return _lookup(in_ids, tid, n_cells)


def inverse_gather_table(fine_ids, fine_mask, coarse_ids, coarse_mask,
                         fine_grid, kernel_size, stride, padding):
    """Gather table of an INVERSE sparse conv (spconv SparseInverseConv3d
    with indice-key reuse): features live on the coarse grid (the strided
    conv's output), outputs land on the fine grid's active sites (its
    input).  Fine site i and tap k read coarse site o = (i + p - k) / s
    where divisible and in range.  Per sample -> (K, V_fine) int32 slots
    into the coarse table with V_coarse as the padding row."""
    sz, sy, sx = _as3(stride)
    pz, py, px = _as3(padding)
    onx, ony, onz = out_grid_size(fine_grid, kernel_size, stride, padding)
    n_out_cells = onx * ony * onz
    z, y, x = delinearize(torch.where(fine_mask, fine_ids, 0), fine_grid)
    offs = kernel_offsets(kernel_size).to(fine_ids.device)
    cz = z[None, :] + pz - offs[:, 0:1]
    cy = y[None, :] + py - offs[:, 1:2]
    cx = x[None, :] + px - offs[:, 2:3]
    divisible = (cz % sz == 0) & (cy % sy == 0) & (cx % sx == 0)
    oz = torch.div(cz, sz, rounding_mode='floor')
    oy = torch.div(cy, sy, rounding_mode='floor')
    ox = torch.div(cx, sx, rounding_mode='floor')
    valid = (fine_mask[None, :] & divisible & (oz >= 0) & (oz < onz)
             & (oy >= 0) & (oy < ony) & (ox >= 0) & (ox < onx))
    tid = torch.where(valid, oz * (ony * onx) + oy * onx + ox, n_out_cells)
    return _lookup(coarse_ids, tid, n_out_cells)


# Bytes of the gathered (B, K, Vout, Cin) operand above which gather_gemm_b
# consumes the taps in chunks (glenet_tpu's GATHER_BYTES_BUDGET).
GATHER_BYTES_BUDGET = 256 * 1024 * 1024


def gather_gemm_b(features, nbr_idx, weights):
    """Sparse-conv contraction over a row table: features (B, V, Cin),
    nbr_idx (B, K, Vout) with V as the padding row, weights (K, Cin, Cout)
    -> (B, Vout, Cout) in the features' dtype.  Above GATHER_BYTES_BUDGET
    the taps are gathered and contracted in chunks sized to the budget.
    Autograd turns the row gathers into index_add_ scatters (the JAX
    package keeps default AD here too)."""
    b, v, cin = features.shape
    k, vq = nbr_idx.shape[1], nbr_idx.shape[2]
    gdtype = _gather_dtype(features)
    padded = torch.cat([features, features.new_zeros((b, 1, cin))],
                       dim=1).to(gdtype)
    w = weights.to(gdtype)
    itemsize = torch.empty((), dtype=gdtype).element_size()
    chunk = k
    if b * k * vq * cin * itemsize > GATHER_BYTES_BUDGET:
        chunk = max(1, GATHER_BYTES_BUDGET // (b * vq * cin * itemsize))
    acc = None
    for k0 in range(0, k, chunk):
        gathered = _take_rows_merged(padded, nbr_idx[:, k0:k0 + chunk])
        part = _contract('bkvc,kco->bvo', gathered, w[k0:k0 + chunk])
        acc = part if acc is None else acc + part
    return acc.to(features.dtype)


def to_dense(features, ids, mask, grid):
    """One sample's (V, C) sparse rows -> (nz, ny, nx, C) dense; invalid
    rows land in a dump row that is cut off."""
    nx, ny, nz = grid
    n_cells = nz * ny * nx
    flat = torch.where(mask, ids, n_cells).long()
    rows = torch.where(mask[:, None], features, 0.0)
    dense = features.new_zeros((n_cells + 1, features.shape[-1]))
    dense = dense.index_put((flat,), rows)
    return dense[:n_cells].reshape(nz, ny, nx, features.shape[-1])
