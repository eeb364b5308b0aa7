"""The port's merge-resolve plain version (the CPU side of
glenet_tpu_torch/ops/merge_kernel.py) against glenet_tpu's sort path
`merged_searchsorted_deltas` and its Pallas kernel in interpret mode.
Integer outputs, so every comparison is exact."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from glenet_tpu.ops import merge_kernel as jmk  # noqa: E402
from glenet_tpu.ops import sparse as jsp  # noqa: E402

from glenet_tpu_torch.ops import merge_kernel as tmk  # noqa: E402
from glenet_tpu_torch.utils import trace  # noqa: E402


def _case(rng, v, n_active, g, vq, n_cells):
    """Sentinel-padded sorted table, sorted shifted query rows (some below
    the table: clipped at -1)."""
    cells = np.sort(rng.choice(n_cells, size=n_active, replace=False))
    ids = np.full((v,), n_cells, np.int64)
    ids[:n_active] = cells
    shifts = rng.randint(-n_cells // 4, n_cells // 4, size=(g,))
    base = np.take(ids, np.clip(np.arange(vq), 0, v - 1))
    queries = np.stack([np.clip(base + s, -1, None) for s in shifts])
    return ids.astype(np.int32), queries.astype(np.int32)


def _all_sentinel(_seed):
    n_cells = 1000
    ids = np.full((32,), n_cells, np.int32)
    q = np.sort(np.random.RandomState(1).randint(
        0, n_cells + 1, size=(1, 40))).astype(np.int32)
    return ids, q


def _below_table(seed):
    r = np.random.RandomState(seed)
    ids = np.sort(r.choice(np.arange(500, 900), 48, replace=False)
                  ).astype(np.int32)
    q = np.sort(r.randint(-50, 600, size=(3, 56)), axis=1).astype(np.int32)
    return ids, q


def _sorted(r, lo, hi, shape):
    return np.sort(r.randint(lo, hi, size=shape), axis=-1).astype(np.int32)


# The cases below are those chip_smoke.py holds the CUDA kernel to: table
# windows wider than its shared buffer, ragged and single-query rows, a
# tiny table, constant rows, runs of sentinels, queries all past or all
# below the table, one row.  Values stay below 2^26 (the sort path's range),
# and the tiny table has 2 slots, the fewest the sort path takes.
def _wide_windows(seed):
    r = np.random.RandomState(seed)
    return (_sorted(r, 0, 1 << 26, (1_000_000,)),
            _sorted(r, -5, (1 << 26) + 5, (3, 3000)))


def _equal_queries(seed):
    ids = _sorted(np.random.RandomState(seed), 0, 1000, (3000,))
    vals = np.array([ids[1500], ids[1500] + 1, ids[0] - 5, ids[-1] + 7])
    return ids, np.repeat(vals[:, None], 1100, axis=1).astype(np.int32)


def _sentinel_runs(seed):
    r = np.random.RandomState(seed)
    n_cells = 100_000
    ids = np.concatenate([_sorted(r, 0, n_cells, (300,)),
                          np.full((2000,), n_cells, np.int32)])
    return ids, _sorted(r, -2, n_cells + 6, (9, 2500))


CASES = {
    'random': lambda s: _case(np.random.RandomState(s), 64, 40 + s, 3, 64,
                              480),
    'all_sentinel': _all_sentinel,
    'below_table': _below_table,
    'wide_windows': _wide_windows,
    'ragged_vq': lambda s: (_sorted(np.random.RandomState(s), 0, 20_000,
                                    (700,)),
                            _sorted(np.random.RandomState(s + 9), -3, 20_003,
                                    (3, 5001))),
    'vq_1': lambda s: (_sorted(np.random.RandomState(s), 0, 5000, (700,)),
                       _sorted(np.random.RandomState(s + 9), -10, 5010,
                               (9, 1))),
    'v_2': lambda s: (np.array([40 + s, 41 + s], np.int32),
                      _sorted(np.random.RandomState(s), 0, 90, (3, 300))),
    'equal_queries': _equal_queries,
    'sentinel_runs': _sentinel_runs,
    'past_table': lambda s: (_sorted(np.random.RandomState(s), 0, 50_000,
                                     (800,)),
                             _sorted(np.random.RandomState(s + 9), 50_000,
                                     1 << 26, (9, 600))),
    'below_all': lambda s: (_sorted(np.random.RandomState(s), 0, 50_000,
                                    (800,)),
                            _sorted(np.random.RandomState(s + 9), -(1 << 26),
                                    0, (9, 600))),
    'b1_g1': lambda s: (_sorted(np.random.RandomState(s), 0, 200_000,
                                (5000,)),
                        _sorted(np.random.RandomState(s + 9), -5, 200_005,
                                (1, 6000))),
}


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('kind', sorted(CASES))
def test_plain_matches_sort_path(kind, seed):
    ids, queries = CASES[kind](seed)
    ref = jax.jit(jsp.merged_searchsorted_deltas)(ids, queries)
    got = tmk.resolve_sorted_queries(torch.from_numpy(ids)[None],
                                     torch.from_numpy(queries)[None])
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(r))


def test_plain_matches_pallas_interpret():
    pairs = [_case(np.random.RandomState(s), 64, 40 + s, 3, 64, 480)
             for s in range(2)]
    ids = np.stack([p[0] for p in pairs])
    queries = np.stack([p[1] for p in pairs])
    ref = jmk.resolve_sorted_queries(jnp.asarray(ids), jnp.asarray(queries),
                                     interpret=True)
    got = tmk.resolve_sorted_queries_plain(torch.from_numpy(ids),
                                           torch.from_numpy(queries))
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_wrapper_checks_inputs():
    ids = torch.zeros((1, 8), dtype=torch.int32)
    q = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        tmk.resolve_sorted_queries(ids.long(), q)
    with pytest.raises(ValueError):
        tmk.resolve_sorted_queries(ids, q[0])
    with pytest.raises(ValueError):
        tmk.resolve_sorted_queries(
            torch.zeros((1, 1 << 20), dtype=torch.int32), q)
    with pytest.raises(ValueError, match='unsupported device'):
        tmk.resolve_sorted_queries_counted(ids, q)
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tmk.resolve_sorted_queries(ids, q)
    assert 'merge_launches' not in trace.counters(), \
        'the CPU path launches no kernel'
