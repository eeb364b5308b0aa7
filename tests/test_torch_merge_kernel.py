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


CASES = {
    'random': lambda s: _case(np.random.RandomState(s), 64, 40 + s, 3, 64,
                              480),
    'all_sentinel': _all_sentinel,
    'below_table': _below_table,
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
    before = tmk.LAUNCHES
    tmk.resolve_sorted_queries(ids, q)
    assert tmk.LAUNCHES == before, 'the CPU path launches no kernel'
