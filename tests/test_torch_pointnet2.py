"""Parity of the port's PointNet++ primitives (glenet_tpu_torch/ops/
pointnet2.py) with glenet_tpu/ops/pointnet2.py on the CPU, numpy-drawn
inputs, f32 on both sides.

Integers exactly: ball-query indices and empty flags (partly filled,
empty and masked balls, queries sitting on points, more hits than
nsample), farthest-point-sample indices (masks, duplicate points, more
keypoints than valid points, so the picks run past the valid count);
three_nn distances and three_interpolate rtol 1e-5."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from glenet_tpu.ops import pointnet2 as jpn2  # noqa: E402

from glenet_tpu_torch.ops import pointnet2 as pn2  # noqa: E402


def _cloud(seed, b=2, n=300, m=64):
    """Points in a 4 m cube (mask drops ~20%), queries: a third on points,
    a third near the cloud, a third 20 m away (empty balls)."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-2, 2, (b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.2
    q = rng.uniform(-2, 2, (b, m, 3)).astype(np.float32)
    q[:, :m // 3] = xyz[:, rng.choice(n, m // 3, replace=False)]
    q[:, 2 * m // 3:] += 20.0
    return xyz, mask, q


def _jax_ball_query(radius, nsample, xyz, q, mask):
    return jax.tree.map(np.asarray, jax.vmap(
        lambda x, nx, mk: jpn2.ball_query(radius, nsample, x, nx, mk))(
        jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(mask)))


@pytest.mark.parametrize('radius,nsample', [(0.3, 8), (0.8, 16), (1.5, 32)])
def test_ball_query_exact(radius, nsample):
    xyz, mask, q = _cloud(0)
    ref_idx, ref_empty = _jax_ball_query(radius, nsample, xyz, q, mask)
    idx, empty = pn2.ball_query(radius, nsample, torch.from_numpy(xyz),
                                torch.from_numpy(q), torch.from_numpy(mask))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(empty.numpy(), ref_empty)
    # the cases the test is for
    assert ref_empty.any() and not ref_empty.all()
    assert (ref_idx[~ref_empty] == 0).mean() < 0.5
    assert (ref_idx[ref_empty] == 0).all()
    counts = np.array([[len(set(r)) for r in s] for s in ref_idx])
    assert ((counts > 1) & (counts < nsample)).any()


def test_ball_query_chunks_give_the_same_indices(monkeypatch):
    """Queries taken in chunks (as full-width sources are) give the indices
    of one block."""
    xyz, mask, q = _cloud(1)
    args = (0.8, 16, torch.from_numpy(xyz), torch.from_numpy(q),
            torch.from_numpy(mask))
    whole = pn2.ball_query(*args)
    monkeypatch.setattr(pn2, 'CHUNK_ELEMENTS', 7 * 2 * 300)
    parts = pn2.ball_query(*args)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ball_query_without_mask():
    xyz, _, q = _cloud(2)
    ref_idx, ref_empty = jax.tree.map(np.asarray, jax.vmap(
        lambda x, nx: jpn2.ball_query(0.8, 16, x, nx))(
        jnp.asarray(xyz), jnp.asarray(q)))
    idx, empty = pn2.ball_query(0.8, 16, torch.from_numpy(xyz),
                                torch.from_numpy(q))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(empty.numpy(), ref_empty)


@pytest.mark.parametrize('case', ['masked', 'duplicates', 'past_valid'])
def test_farthest_point_sample_exact(case):
    rng = np.random.RandomState(3)
    b, n, k = 2, 256, 64
    xyz = rng.uniform(-10, 10, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    if case == 'masked':
        mask = rng.uniform(size=(b, n)) > 0.3
        mask[1, :5] = False                  # the first valid index is not 0
    elif case == 'duplicates':
        xyz[:, 100:200] = xyz[:, :100]       # every point of 0..99 twice
        xyz[:, 200:] = xyz[:, :1]
    else:
        mask[:] = False
        mask[0, rng.choice(n, 20, replace=False)] = True
        mask[1, 7:40] = True                 # fewer valid points than k
    ref = np.asarray(jax.vmap(
        lambda x, mk: jpn2.farthest_point_sample(x, k, mk))(
        jnp.asarray(xyz), jnp.asarray(mask)))
    got = pn2.farthest_point_sample(torch.from_numpy(xyz), k,
                                    torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert mask[np.arange(b)[:, None], ref].all()
    if case == 'past_valid':
        assert len(set(ref[1])) == 33 < k


def test_farthest_point_sample_without_mask():
    rng = np.random.RandomState(4)
    xyz = rng.randn(2, 128, 3).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda x: jpn2.farthest_point_sample(x, 32))(
        jnp.asarray(xyz)))
    got = pn2.farthest_point_sample(torch.from_numpy(xyz), 32)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[:, 0].tolist() == [0, 0]


def test_three_nn_and_interpolate():
    rng = np.random.RandomState(5)
    unknown = rng.uniform(-3, 3, (2, 80, 3)).astype(np.float32)
    known = rng.uniform(-3, 3, (2, 40, 3)).astype(np.float32)
    known[:, 10] = known[:, 3]               # a tie: the lower index first
    unknown[:, 0] = known[:, 3]              # ... at distance 0
    mask = np.ones((2, 40), bool)
    mask[0, 20:] = False
    feats = rng.randn(2, 40, 5).astype(np.float32)
    ref_d, ref_i = jax.tree.map(np.asarray, jax.vmap(jpn2.three_nn)(
        jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(mask)))
    d, i = pn2.three_nn(torch.from_numpy(unknown), torch.from_numpy(known),
                        torch.from_numpy(mask))
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_allclose(d.numpy(), ref_d, rtol=1e-5, atol=1e-6)
    assert ref_i[:, 0, :2].tolist() == [[3, 10], [3, 10]]
    ref_f = np.asarray(jax.vmap(jpn2.three_interpolate)(
        jnp.asarray(feats), jnp.asarray(ref_i), jnp.asarray(ref_d)))
    got_f = pn2.three_interpolate(torch.from_numpy(feats), i, d)
    np.testing.assert_allclose(got_f.numpy(), ref_f, rtol=1e-5, atol=1e-6)


def test_group_points_backward_is_a_scatter_add():
    """group_points gathers rows per sample; its gradient sums the
    repeated picks."""
    feats = torch.randn(2, 10, 4, requires_grad=True)
    idx = torch.tensor([[[0, 0, 3]], [[9, 1, 1]]])
    out = pn2.group_points(feats, idx)
    torch.testing.assert_close(out[1, 0, 0], feats[1, 9])
    out.sum().backward()
    assert feats.grad[0, 0, 0] == 2 and feats.grad[1, 1, 0] == 2
    assert feats.grad[0, 1].abs().sum() == 0
