"""Parity of the port's VectorPool aggregation (glenet_tpu_torch/models/
vector_pool.py) with glenet_tpu/models/vector_pool.py, on the CPU, same
numpy-drawn inputs and weights, f32 on both sides; glenet_tpu's functions
run vmapped over the batch and jitted, as its detector runs them:

  - local_grid_offsets exactly;
  - three_nn_within, cube and ball, on clouds offset to Waymo-scale
    coordinates (|q|^2 ~ 1e3 m^2): indices and valid flags exactly,
    distances rtol 1e-6;
  - interpolate_into_grids with rows of 0, 1, 2 and 3 valid neighbours:
    atol 1e-5;
  - pool_into_grids, avg and choice, nsample -1 and 3, with support points
    on sub-voxel edges: the empty sub-voxels and the chosen offsets
    exactly, features (and avg's offsets) atol 1e-6;
  - sample_points_with_roi_mask with invalid rois: exactly;
  - VectorPoolAggregationMSG (interpolation and random choice), forward in
    eval and train mode rtol 1e-4 / atol 1e-5, BN running stats rtol 1e-4 /
    atol 1e-5, and its backward against jax.vjp: the input features' and
    every parameter's cotangent per tensor max |diff| <= 2e-4 max |grad| +
    1e-6 (torch_parity.assert_grads_equal's bound)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

from glenet_tpu.models import vector_pool as jvp  # noqa: E402
from glenet_tpu_torch.models import vector_pool as tvp  # noqa: E402

OFFSET = np.array([31.0, -22.0, 1.5], np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cloud(seed, b=2, n=96, q=40, half=1.0, mask_p=0.25):
    """Support points in a cube of half-width `half` around OFFSET (a
    quarter masked), queries in a slightly larger cube (some fall outside
    every neighbourhood)."""
    rng = np.random.RandomState(seed)
    support = (rng.uniform(-half, half, (b, n, 3)) + OFFSET).astype(
        np.float32)
    mask = rng.rand(b, n) > mask_p
    query = (rng.uniform(-1.3 * half, 1.3 * half, (b, q, 3)) + OFFSET).astype(
        np.float32)
    return support, mask, query


@pytest.mark.parametrize('rmax,num_voxel', [(0.8, (3, 3, 3)),
                                            (0.2, (2, 2, 2)),
                                            (2.4, (3, 2, 4))])
def test_local_grid_offsets(rmax, num_voxel):
    np.testing.assert_array_equal(
        tvp.local_grid_offsets(rmax, num_voxel).numpy(),
        np.asarray(jvp.local_grid_offsets(rmax, num_voxel)))


@pytest.mark.parametrize('neighbor_type', [0, 1])
def test_three_nn_within(neighbor_type):
    support, mask, query = _cloud(1)
    rmax = 0.5
    ref = jax.jit(jax.vmap(lambda q, s, m: jvp.three_nn_within(
        q, s, m, rmax, neighbor_type=neighbor_type, chunk=16)))(
        query, support, mask)
    dist, idx, valid = (np.asarray(r) for r in ref)
    got = tvp.three_nn_within(_t(query), _t(support), _t(mask), rmax,
                              neighbor_type)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), idx)
    # rows with 0, 1, 2 and 3 neighbours all occur
    assert set(valid.sum(-1).ravel()) == {0, 1, 2, 3}
    np.testing.assert_allclose(got[0].numpy(), dist, rtol=1e-6)


def test_three_nn_within_empty_scene():
    """A scene without a valid support point: every slot invalid, index
    0, distance 1e10, as glenet_tpu's argmin over a row of 1e10s."""
    support, mask, query = _cloud(2)
    mask[1] = False
    ref = jax.jit(jax.vmap(lambda q, s, m: jvp.three_nn_within(
        q, s, m, 0.5)))(query, support, mask)
    got = tvp.three_nn_within(_t(query), _t(support), _t(mask), 0.5)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not got[2][1].any()


def test_interpolate_into_grids():
    support, mask, query = _cloud(3, q=12)
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 96, 5).astype(np.float32)
    rmax, num_voxel = 0.15, (2, 2, 2)
    offsets = jvp.local_grid_offsets(rmax, num_voxel)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda s, f, m, q: jvp.interpolate_into_grids(
            s, f, m, q, offsets, rmax, neighbor_type=0,
            distance_multiplier=2.0)))(support, feats, mask, query))
    got = tvp.interpolate_into_grids(
        _t(support), _t(feats), _t(mask), _t(query),
        tvp.local_grid_offsets(rmax, num_voxel), rmax, 0, 2.0)
    centers = (query[:, :, None] + np.asarray(offsets)).reshape(2, -1, 3)
    _, _, valid = tvp.three_nn_within(_t(centers), _t(support), _t(mask),
                                      2 * rmax)
    assert set(valid.sum(-1).numpy().ravel()) == {0, 1, 2, 3}
    assert got.shape == ref.shape == (2, 12, 8, 5 + 9)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # rows without a neighbour are zero; with 1 or 2 the invalid slots'
    # offsets point at support point 0
    empty = ~valid[..., 0].numpy().reshape(2, 12, 8)
    assert not got.numpy()[empty].any()


def _edge_cloud(seed, rmax, num_voxel, b=2, n=80, q=6):
    """Support points around the queries, a third of them placed exactly
    on sub-voxel boundaries (offset + rmax a multiple of the step) along
    one axis."""
    rng = np.random.RandomState(seed)
    query = (rng.uniform(-0.3, 0.3, (b, q, 3)) + OFFSET).astype(np.float32)
    support = (rng.uniform(-rmax, rmax, (b, n, 3))
               + query[:, rng.randint(q, size=n)][np.arange(b)[:, None],
                                                   np.arange(n)]
               ).astype(np.float32)
    steps = np.float32(2.0 * rmax) / np.float32(num_voxel[0])
    for i in range(b):
        for j in range(0, n, 3):
            k = rng.randint(1, num_voxel[0])
            qq = query[i, rng.randint(q)]
            rel = np.float32(k) * steps - np.float32(rmax)
            support[i, j, 0] = qq[0] + rel
    mask = rng.rand(b, n) > 0.2
    return support, mask, query


@pytest.mark.parametrize('avg', [False, True])
@pytest.mark.parametrize('nsample', [-1, 3])
def test_pool_into_grids(avg, nsample):
    rmax, num_voxel = 0.8, (3, 3, 3)
    support, mask, query = _edge_cloud(5, rmax, num_voxel)
    feats = np.random.RandomState(6).randn(2, 80, 4).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda s, f, m, q: jvp.pool_into_grids(
            s, f, m, q, rmax, num_voxel, avg=avg, nsample=nsample,
            chunk=4)))(support, feats, mask, query))
    got = tvp.pool_into_grids(_t(support), _t(feats), _t(mask), _t(query),
                              rmax, num_voxel, avg, nsample).numpy()
    assert got.shape == ref.shape == (2, 6, 27, 3 + 4)
    empty = ~(ref != 0).any(-1)
    np.testing.assert_array_equal(~(got != 0).any(-1), empty)
    assert 0 < empty.sum() < empty.size
    if not avg:
        np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_sample_points_with_roi_mask():
    rng = np.random.RandomState(7)
    pts = (rng.uniform(-12, 12, (2, 500, 3)) + OFFSET).astype(np.float32)
    pmask = rng.rand(2, 500) > 0.1
    rois = np.zeros((2, 6, 7), np.float32)
    rois[..., :3] = rng.uniform(-8, 8, (2, 6, 3)) + OFFSET
    rois[..., 3:6] = rng.uniform(0.5, 5, (2, 6, 3))
    rois[..., 6] = rng.uniform(-3, 3, (2, 6))
    roi_valid = np.array([[1, 1, 1, 0, 0, 1], [0, 0, 0, 0, 0, 0]], bool)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda p, m, r, v: jvp.sample_points_with_roi_mask(
            p, m, r, v, 1.6)))(pts, pmask, rois, roi_valid))
    got = tvp.sample_points_with_roi_mask(_t(pts), _t(pmask), _t(rois),
                                          _t(roi_valid), 1.6).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref[0].sum() < pmask[0].sum() and not ref[1].any()


MSG_CFGS = {
    'interp': {
        'NUM_GROUPS': 2, 'LOCAL_AGGREGATION_TYPE': 'local_interpolation',
        'NUM_REDUCED_CHANNELS': 2, 'NUM_CHANNELS_OF_LOCAL_AGGREGATION': 8,
        'MSG_POST_MLPS': [16],
        'GROUP_CFG_0': {'NUM_LOCAL_VOXEL': [2, 2, 2],
                        'MAX_NEIGHBOR_DISTANCE': 0.2,
                        'NEIGHBOR_NSAMPLE': -1, 'POST_MLPS': [8, 8]},
        'GROUP_CFG_1': {'NUM_LOCAL_VOXEL': [3, 3, 3],
                        'MAX_NEIGHBOR_DISTANCE': 0.4,
                        'NEIGHBOR_NSAMPLE': -1, 'POST_MLPS': [8, 8]}},
    'choice': {
        'NUM_GROUPS': 2, 'LOCAL_AGGREGATION_TYPE': 'voxel_random_choice',
        'NUM_REDUCED_CHANNELS': 3, 'NUM_CHANNELS_OF_LOCAL_AGGREGATION': 8,
        'MSG_POST_MLPS': [16],
        'GROUP_CFG_0': {'NUM_LOCAL_VOXEL': [3, 3, 3],
                        'MAX_NEIGHBOR_DISTANCE': 0.8,
                        'NEIGHBOR_NSAMPLE': 32, 'POST_MLPS': [8, 8]},
        'GROUP_CFG_1': {'NUM_LOCAL_VOXEL': [3, 3, 3],
                        'MAX_NEIGHBOR_DISTANCE': 1.6,
                        'NEIGHBOR_NSAMPLE': 32, 'POST_MLPS': [8, 8]}}}


MSG_OFFSET = OFFSET / 10


def _msg_inputs(kind):
    """(xyz, mask, feats, new_xyz): a cloud of 200 points around
    MSG_OFFSET (its features 4 channels for interpolation, 6 for choice:
    reduced to 2 and 3) and 10 queries among them.  The module's last BN
    normalises 20 rows that carry the absolute query xyz: at OFFSET, tens
    of metres out with a spread of 1 m, its moments would cancel ~1e3-fold
    and amplify each package's rounding past the stated tolerance."""
    rng = np.random.RandomState(8)
    xyz = (rng.uniform(-1, 1, (2, 200, 3)) + MSG_OFFSET).astype(np.float32)
    mask = rng.rand(2, 200) > 0.2
    feats = rng.randn(2, 200, 4 if kind == 'interp' else 6).astype(
        np.float32)
    new_xyz = (rng.uniform(-0.8, 0.8, (2, 10, 3)) + MSG_OFFSET).astype(
        np.float32)
    return xyz, mask, feats, new_xyz


@pytest.fixture(scope='module', params=['interp', 'choice'])
def msg(request):
    """JAX's module on seeded weights: eval and train forward, the train
    batch stats and jax.vjp of the train forward (in feats and params)
    with a fixed cotangent; the port's module with the same weights."""
    from glenet_tpu.config import Cfg as JCfg

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    kind = request.param
    xyz, mask, feats, new_xyz = _msg_inputs(kind)
    mod = jvp.VectorPoolAggregationMSG(model_cfg=dict(JCfg(MSG_CFGS[kind])))
    shapes = jax.eval_shape(lambda k: mod.init(k, xyz, mask, feats, new_xyz,
                                               train=False),
                            jax.random.PRNGKey(0))
    variables = tp.random_variables(shapes, seed=9)
    v = jax.tree.map(jnp.asarray, variables)
    # the inputs go in as arguments: closed over, XLA would fold their
    # sums of squares at compile time with other roundings
    args = tuple(jnp.asarray(x) for x in (xyz, mask, feats, new_xyz))
    evl = np.asarray(jax.jit(lambda v, a: mod.apply(
        v, *a, train=False))(v, args))

    @jax.jit
    def train_vjp(v, a, cot):
        def fwd(params, f):
            return mod.apply({'params': params,
                              'batch_stats': v['batch_stats']},
                             a[0], a[1], f, a[3], train=True,
                             mutable=['batch_stats'])

        (out, state), vjp = jax.vjp(fwd, v['params'], a[2])
        return out, state, vjp((cot, jax.tree.map(jnp.zeros_like, state)))

    cot = np.random.RandomState(10).randn(2, 10, 16).astype(np.float32)
    out, state, (g_params, g_feats) = train_vjp(v, args, jnp.asarray(cot))
    port = tvp.VectorPoolAggregationMSG(Cfg(MSG_CFGS[kind]), feats.shape[-1])
    load_jax_variables(port, variables)
    return {'kind': kind, 'inputs': (xyz, mask, feats, new_xyz),
            'eval': evl, 'train': np.asarray(out), 'cot': cot,
            'stats': jax.tree.map(np.asarray, state['batch_stats']),
            'g_params': jax.tree.map(np.asarray, g_params),
            'g_feats': np.asarray(g_feats), 'port': port}


def test_msg_eval_forward(msg):
    xyz, mask, feats, new_xyz = (_t(x) for x in msg['inputs'])
    with torch.no_grad():
        got = msg['port'](xyz, mask, feats, new_xyz, train=False)
    assert got.shape == (2, 10, 16)
    tp.assert_close(got, msg['eval'])


def test_msg_train_forward_and_backward(msg):
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    port = msg['port']
    xyz, mask, feats, new_xyz = (_t(x) for x in msg['inputs'])
    feats = feats.clone().requires_grad_()
    port.zero_grad()
    out = port(xyz, mask, feats, new_xyz, train=True)
    tp.assert_close(out.detach(), msg['train'])
    (out * _t(msg['cot'])).sum().backward()
    ref = jax_tree_to_port(port, msg['g_params'])
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(ref) == set(grads)
    for k in ('group_0.separate_w', 'group_1.separate_w', 'msg_0.weight'):
        assert float(grads[k].abs().max()) > 0, k
    for k, g_ref in list(ref.items()) + [('feats', msg['g_feats'])]:
        g = (feats.grad if k == 'feats' else grads[k]).numpy()
        tol = 2e-4 * np.abs(g_ref).max() + 1e-6
        assert np.abs(g - g_ref).max() <= tol, (k, np.abs(g - g_ref).max(),
                                                tol)
    buffers = dict(port.named_buffers())
    stats = jax_tree_to_port(port, msg['stats'], 'batch_stats')
    assert len(stats) == len([k for k in buffers if 'running' in k])
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_separate_w_init_scale():
    """The seeded init follows flax's kaiming_normal on (G, C_in, D): std
    sqrt(2 / (G C_in)), truncated at 2 sigma."""
    torch.manual_seed(0)
    grp = tvp.VectorPoolAggregation(32, (3, 3, 3), 1.2,
                                    num_reduced_channels=32,
                                    num_local_agg_channels=32)
    w = grp.separate_w.detach()
    assert w.shape == (27, 32 + 9, 32)
    std = np.sqrt(2.0 / (27 * 41))
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / .87962566103423978 + 1e-6
