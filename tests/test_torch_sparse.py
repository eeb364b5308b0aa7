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
from glenet_tpu_torch.ops import xblock_gemm as txg  # noqa: E402

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


@pytest.mark.parametrize('gather', ['bf16', 'f32'])
@pytest.mark.parametrize('seed', [0, 1])
def test_strided_function_backward(seed, gather, monkeypatch):
    """The strided convs' autograd Function (which saves only its inputs
    and re-runs the plain composition in its backward) against autograd of
    that composition: the forward, d_features and d_weights.  The same
    arithmetic on the same inputs, so only the CPU GEMM's blocking could
    move a last bit (rtol 1e-6)."""
    if gather == 'f32':
        monkeypatch.setattr(tsp, 'GATHER_COMPUTE_DTYPE', None)
    ids, mask, feats = _tables(seed)
    w = _weights(seed + 7)
    oi, om = zip(*(tsp.strided_output_sites(torch.from_numpy(ids[b]),
                                            torch.from_numpy(mask[b]), GRID,
                                            3, 2, 1, 48)
                   for b in range(ids.shape[0])))
    q, tbl = tsp.strided_xblock_table_b(
        torch.from_numpy(ids), torch.from_numpy(mask), torch.stack(oi),
        torch.stack(om), GRID, 2, 1)
    g = torch.from_numpy(np.random.RandomState(seed + 9).randn(
        2, 48, COUT).astype(np.float32))
    grads = []
    for fn in (tsp.gather_gemm_xblocks_b, tsp.gather_gemm_xblocks_plain):
        f = torch.from_numpy(feats).requires_grad_()
        w_t = torch.from_numpy(w).requires_grad_()
        out = fn(f, q, tbl, w_t)
        out.backward(g)
        grads.append((out.detach(), f.grad, w_t.grad))
    for got, ref, name in zip(*grads, ('out', 'd_features', 'd_weights')):
        assert got.dtype == torch.float32 and got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-7 * float(ref.abs().max()),
                                   err_msg=name)


def test_strided_function_saves_inputs_only():
    """The strided Function keeps its four inputs for the backward and no
    per-tap operand: the saved tensors are the inputs themselves."""
    ids, mask, feats = _tables(2)
    q, tbl = tsp.subm_xblock_table_b(torch.from_numpy(ids),
                                     torch.from_numpy(mask), GRID)
    f = torch.from_numpy(feats).requires_grad_()
    w = torch.from_numpy(_weights(2)).requires_grad_()
    out = tsp.gather_gemm_xblocks_b(f, q, tbl, w)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4
    assert all(s.data_ptr() == t.data_ptr() for s, t in
               zip(saved, (f, q, tbl, w)))


@pytest.mark.parametrize('wants', ['both', 'features', 'weights'])
def test_strided_function_backward_skips_forward_product(wants, monkeypatch):
    """The strided Function's backward never forms the forward product
    per_tap @ W: its matrix products are g W^T for d_features and
    per_tap^T g for d_weights, each as many flops as the forward, and only
    those the inputs that take a gradient need."""
    from torch.utils.flop_counter import FlopCounterMode
    ids, mask, feats = _tables(3)
    q, tbl = tsp.subm_xblock_table_b(torch.from_numpy(ids),
                                     torch.from_numpy(mask), GRID)
    f = torch.from_numpy(feats).requires_grad_(wants != 'weights')
    w = torch.from_numpy(_weights(3)).requires_grad_(wants != 'features')
    with FlopCounterMode(display=False) as fwd:
        out = tsp.gather_gemm_xblocks_b(f, q, tbl, w)
    monkeypatch.setattr(tsp, 'gather_gemm_xblocks_plain', None)
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    product = 2 * q.numel() * 3 * CIN * COUT
    assert fwd.get_total_flops() == product
    assert bwd.get_total_flops() == product * (2 if wants == 'both' else 1)
    assert (f.grad is not None) == (wants != 'weights')
    assert (w.grad is not None) == (wants != 'features')


def _contract_args(change):
    """Arguments of the x-block contraction with one of them made wrong."""
    ids, mask, feats = _tables(0)
    q, tbl = tsp.subm_xblock_table_b(torch.from_numpy(ids),
                                     torch.from_numpy(mask), GRID)
    args = {'features': torch.from_numpy(feats), 'q': q, 'tbl': tbl,
            'weights': torch.from_numpy(_weights(0))}
    name, make = change
    args[name] = make(args[name])
    return args


@pytest.mark.parametrize('change,error', [
    (('q', lambda t: t.long()), TypeError),
    (('tbl', lambda t: t.to(torch.int16)), TypeError),
    (('features', lambda t: t.to(torch.int32)), TypeError),
    (('weights', lambda t: t.to(torch.int32)), TypeError),
    (('features', lambda t: t[0]), ValueError),
    (('q', lambda t: t[:, :3]), ValueError),
    (('tbl', lambda t: t[:, :, :-1]), ValueError),
    (('weights', lambda t: t[:9]), ValueError),
    (('weights', lambda t: t.reshape(27, -1)), ValueError),
    (('q', lambda t: torch.empty(t.shape, dtype=t.dtype, device='meta')),
     ValueError),
], ids=['q_int64', 'tbl_int16', 'features_int', 'weights_int',
        'features_rank2', 'q_3_groups', 'tbl_shape', 'weights_taps',
        'weights_rank2', 'q_other_device'])
def test_xblock_contraction_refuses(change, error):
    """Both autograd Functions and the kernel's wrapper refuse an argument
    outside the contract (dtype, rank, shape, device) before any work."""
    args = _contract_args(change)
    for fn in (tsp.gather_gemm_xblocks_b, tsp.subm_gather_gemm_xblocks_b):
        with pytest.raises(error):
            fn(**args)


def test_xblock_kernel_wrapper_refuses_cpu():
    """The kernel's wrapper takes CUDA tensors only: a CPU tensor raises
    instead of falling back."""
    args = _contract_args(('q', lambda t: t))
    with pytest.raises(ValueError, match='unsupported device'):
        txg.gather_gemm(*args.values(), True)


def test_strided_function_backward_imports_nothing():
    """The strided Function's first backward loads no module: autograd
    with a grad_outputs tensor imports torch.fx's symbolic shapes (sympy),
    seconds of a process's first train step on the card."""
    import subprocess
    import sys
    code = '''if True:
        import sys, torch
        from glenet_tpu_torch.ops import sparse as tsp
        ids = torch.arange(0, 480, 8, dtype=torch.int32)[None]
        q, tbl = tsp.subm_xblock_table_b(ids, ids < 480, (10, 8, 6))
        f = torch.randn(1, 60, 4, requires_grad=True)
        w = torch.randn(27, 4, 8, requires_grad=True)
        out = tsp.gather_gemm_xblocks_b(f, q, tbl, w)
        before = set(sys.modules)
        out.sum().backward()
        print(sorted(set(sys.modules) - before))
    '''
    root = str(__import__('pathlib').Path(__file__).resolve().parent.parent)
    res = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == '[]', res.stdout
