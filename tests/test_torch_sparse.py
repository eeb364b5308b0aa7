"""The port's sparse-conv primitives (glenet_tpu_torch/ops/sparse.py)
against glenet_tpu's sort path, f32 on both sides.

The port always builds x-block tables in the kernel-path form (raw shifted
queries); the JAX default substitutes a sentinel at invalid taps.  So hit
bits 0-2 must agree everywhere, and q plus the rank bits 3-4 wherever the
tap group is valid.  Contractions: rtol 1e-5 / atol 1e-6, the tolerance of
tests/test_merge_kernel.py (f32 sums in another order)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from glenet_tpu.ops import sparse as jsp  # noqa: E402

from glenet_tpu_torch.ops import sparse as tsp  # noqa: E402

GRID = (10, 8, 6)
N_CELLS = 480
CIN, COUT = 4, 8


def _tables(seed, n_active=(40, 41), cap=64):
    ids, mask, feats = [], [], []
    for s, n in enumerate(n_active):
        r = np.random.RandomState(seed * 10 + s)
        cells = np.sort(r.choice(N_CELLS, size=n, replace=False))
        i = np.full((cap,), N_CELLS, np.int32)
        i[:n] = cells
        m = np.zeros((cap,), bool)
        m[:n] = True
        ids.append(i)
        mask.append(m)
        feats.append(np.where(m[:, None], r.randn(cap, CIN), 0)
                     .astype(np.float32))
    return np.stack(ids), np.stack(mask), np.stack(feats)


def _weights(seed):
    return (np.random.RandomState(seed).randn(27, CIN, COUT) * 0.1
            ).astype(np.float32)


def _group_valid(z, y, mask, lo, grid):
    """(B, 9, V) validity of the (dz, dy) groups at offsets lo..lo+2."""
    nx, ny, nz = grid
    d = np.stack(np.meshgrid(np.arange(lo, lo + 3), np.arange(lo, lo + 3),
                             indexing='ij'), -1).reshape(-1, 2)
    tz = z[:, None] + d[None, :, 0:1]
    ty = y[:, None] + d[None, :, 1:2]
    return mask[:, None] & (tz >= 0) & (tz < nz) & (ty >= 0) & (ty < ny)


def _assert_tables(q_t, tbl_t, q_j, tbl_j, valid_c):
    q_t, tbl_t = q_t.numpy(), tbl_t.numpy()
    q_j, tbl_j = np.asarray(q_j), np.asarray(tbl_j)
    np.testing.assert_array_equal(tbl_t & 7, tbl_j & 7)
    np.testing.assert_array_equal(q_t[valid_c], q_j[valid_c])
    np.testing.assert_array_equal((tbl_t >> 3)[valid_c], (tbl_j >> 3)[valid_c])


@pytest.mark.parametrize('seed', [0, 1])
def test_subm_table_and_contraction(seed):
    ids, mask, feats = _tables(seed)
    w = _weights(seed)
    with tp.pinned_f32():
        q_j, tbl_j, out_j = jax.jit(lambda i, m, f, w_: (
            *jsp.subm_xblock_table_b(i, m, GRID),
            jsp.gather_gemm_xblocks_b(
                f, *jsp.subm_xblock_table_b(i, m, GRID), w_)))(
            ids, mask, feats, w)
        q_t, tbl_t = tsp.subm_xblock_table_b(torch.from_numpy(ids),
                                             torch.from_numpy(mask), GRID)
        out_t = tsp.gather_gemm_xblocks_b(torch.from_numpy(feats), q_t,
                                          tbl_t, torch.from_numpy(w))
    nx, ny, _ = GRID
    lin = np.where(mask, ids, 0)
    valid_c = _group_valid(lin // (nx * ny), (lin % (nx * ny)) // nx, mask,
                           -1, GRID)
    _assert_tables(q_t, tbl_t, q_j, tbl_j, valid_c)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('seed', [0, 1])
def test_strided_table_and_contraction(seed):
    ids, mask, feats = _tables(seed)
    w = _weights(seed + 5)
    oi, om = jax.jit(jax.vmap(lambda i, m: jsp.strided_output_sites(
        i, m, GRID, 3, 2, 1, 48)))(ids, mask)
    oi, om = np.array(oi), np.array(om)
    with tp.pinned_f32():
        q_j, tbl_j, out_j = jax.jit(lambda i, m, oi_, om_, f, w_: (
            *jsp.strided_xblock_table_b(i, m, oi_, om_, GRID, 2, 1),
            jsp.gather_gemm_xblocks_b(f, *jsp.strided_xblock_table_b(
                i, m, oi_, om_, GRID, 2, 1), w_)))(ids, mask, oi, om, feats,
                                                   w)
        q_t, tbl_t = tsp.strided_xblock_table_b(
            torch.from_numpy(ids), torch.from_numpy(mask),
            torch.from_numpy(oi), torch.from_numpy(om), GRID, 2, 1)
        out_t = tsp.gather_gemm_xblocks_b(torch.from_numpy(feats), q_t,
                                          tbl_t, torch.from_numpy(w))
    onx, ony, _ = tsp.out_grid_size(GRID, 3, 2, 1)
    o = np.where(om, oi, 0)
    valid_c = _group_valid((o // (onx * ony)) * 2 - 1,
                           ((o % (onx * ony)) // onx) * 2 - 1, om, 0, GRID)
    _assert_tables(q_t, tbl_t, q_j, tbl_j, valid_c)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('out_cap', [48, 12, 40])
def test_strided_output_sites(out_cap):
    """Exact, including the uniform rank decimation past out_cap."""
    ids, mask, _ = _tables(3)
    for b in range(ids.shape[0]):
        ref = jax.jit(lambda i, m: jsp.strided_output_sites(
            i, m, GRID, 3, 2, 1, out_cap))(ids[b], mask[b])
        got = tsp.strided_output_sites(torch.from_numpy(ids[b]),
                                       torch.from_numpy(mask[b]), GRID, 3, 2,
                                       1, out_cap)
        for r, t in zip(ref, got):
            np.testing.assert_array_equal(t.numpy(), np.asarray(r))


@pytest.mark.parametrize('seed,out_cap', [(0, 944), (1, 611), (2, 1351)])
def test_strided_output_sites_decimation_rounding(seed, out_cap):
    """Decimation past out_cap at budgets where the keep rule's f32
    ratio out_cap / n_active must be a true division: a product with the
    reciprocal rounds differently at these caps and drops a site more."""
    grid, n_cells = (32, 32, 25), 32 * 32 * 25
    rng = np.random.RandomState(seed)
    ids = np.full(512, n_cells, np.int32)
    ids[:448] = np.sort(rng.choice(n_cells, 448, replace=False))
    mask = ids < n_cells
    ref = jax.jit(lambda i, m: jsp.strided_output_sites(
        i, m, grid, 3, 2, 1, out_cap))(ids, mask)
    got = tsp.strided_output_sites(torch.from_numpy(ids),
                                   torch.from_numpy(mask), grid, 3, 2, 1,
                                   out_cap)
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_to_dense_expand():
    ids, mask, feats = _tables(4)
    dense_j, occ_j = jax.jit(lambda f, i, m: jsp.to_dense_expand(
        f, i, m, GRID))(feats, ids, mask)
    dense_t, occ_t = tsp.to_dense_expand(torch.from_numpy(feats),
                                         torch.from_numpy(ids),
                                         torch.from_numpy(mask), GRID)
    np.testing.assert_array_equal(dense_t.numpy(), np.asarray(dense_j))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))


def test_level_caps():
    assert tsp.LEVEL_CAP_MULTIPLIERS == jsp.LEVEL_CAP_MULTIPLIERS
    assert tsp.level_caps(40000) == jsp.level_caps(40000)
