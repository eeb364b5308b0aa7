"""Parity of the port's voxel-query RoI pooling (POOL_MODE: voxel_query,
configs/kitti_models/GLENet_VR_vq.yaml) with glenet_tpu on the CPU.

  - ball_taps: equal to JAX's, 281 taps at each of GLENet-VR's levels;
  - voxel_query_select: slots and empty flags EXACTLY equal to JAX's and to
    the Python oracle of the reference kernel loop
    (tests/test_voxel_query_pool.py), on two seeds, a sparse world with
    empty balls, queries next to the grid's faces, and a radius with fewer
    taps than NSAMPLE (the padding branch); centres atol 1e-5;
  - VoxelQueryPool: eval and train forwards, BN running stats and the
    gradients of jax.vjp, rtol 1e-4 / atol 1e-5 in f32;
  - the toy two-stage config in voxel_query mode: predict (final boxes and
    scores atol 1e-4, valid masks and labels equal) and one train step with
    the JAX step's RoI targets (loss terms, gradients and BN stats as
    tests/test_torch_train_step.py holds them)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_voxel_query_pool as vqp  # noqa: E402
import torch_parity as tp  # noqa: E402

# GLENet-VR's pooled levels: (POOL_RADIUS, stride) on 0.05 x 0.05 x 0.1 m
GLENET_LEVELS = ((0.4, 2), (0.8, 4), (1.6, 8))


@pytest.mark.parametrize('radius,vs,n_taps', [
    *[(r, (0.05 * s, 0.05 * s, 0.1 * s), 281) for r, s in GLENET_LEVELS],
    (0.4, (0.1, 0.1, 0.2), 281), (0.1, (0.1, 0.1, 0.2), 11),
    (0.8, (4.0, 4.0, 0.8), 3)])
def test_ball_taps(radius, vs, n_taps):
    from glenet_tpu.models.roi_heads import ball_taps as jax_taps

    from glenet_tpu_torch.models.roi_heads import ball_taps
    got, ref = ball_taps((4, 4, 4), radius, vs), jax_taps((4, 4, 4), radius,
                                                          vs)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert len(got) == n_taps


def _worlds(seeds, v, q):
    worlds = [vqp.make_world(s, v=v, q=q) for s in seeds]
    rng = np.random.RandomState(seeds[0] + 100)
    nx, ny, nz = vqp.GRID
    ext = np.array([nx * vqp.VS[0], ny * vqp.VS[1], nz * vqp.VS[2]])
    for _, _, _, qxyz in worlds:
        # the first 6 queries sit 1e-3 m inside each of the grid's faces
        for i in range(6):
            axis, hi = divmod(i, 2)
            qxyz[i, axis] = ext[axis] - 1e-3 if hi else 1e-3
        qxyz[6:8] = rng.uniform(0, 1, (2, 3)) * ext * 0.999
    return worlds


@pytest.mark.parametrize('case', ['seed0', 'seed1', 'sparse', 'few_taps'])
def test_voxel_query_select(case, monkeypatch):
    """Slots and empty flags equal to JAX's and to the reference kernel's
    loop; centres atol 1e-5 (to JAX everywhere, to the oracle's voxel
    centres where the ball holds a voxel)."""
    from glenet_tpu.models.roi_heads import ball_taps
    from glenet_tpu.models.roi_heads import voxel_query_select as jax_select

    from glenet_tpu_torch.models.roi_heads import voxel_query_select
    seeds, v, radius = {'seed0': ((0, 2), 60, 0.4),
                        'seed1': ((1, 3), 60, 0.4),
                        'sparse': ((4, 5), 8, 0.4),
                        'few_taps': ((6, 7), 400, 0.1)}[case]
    monkeypatch.setattr(vqp, 'RADIUS', radius)
    taps = ball_taps(vqp.QR, radius, vqp.VS)
    assert (len(taps) < vqp.NSAMPLE) == (case == 'few_taps')
    worlds = _worlds(seeds, v, 40)
    vs, origin = np.asarray(vqp.VS, np.float32), np.zeros(3, np.float32)
    ref = [jax.tree.map(np.asarray, jax_select(
        jnp.asarray(qxyz), jnp.asarray(v2p), jnp.asarray(taps), vqp.GRID,
        jnp.asarray(vs), jnp.asarray(origin), radius, vqp.NSAMPLE))
        for _, v2p, _, qxyz in worlds]
    s16, cen, empty = voxel_query_select(
        torch.from_numpy(np.stack([w[3] for w in worlds])),
        torch.from_numpy(np.stack([w[1] for w in worlds])),
        torch.from_numpy(taps), vqp.GRID, torch.from_numpy(vs),
        torch.from_numpy(origin), radius, vqp.NSAMPLE)
    n_empty = 0
    for b, ((_, v2p, centers, qxyz), (r_s, r_c, r_e)) in enumerate(
            zip(worlds, ref)):
        o_idx, o_empty = vqp.oracle_voxel_query(qxyz, v2p, centers)
        np.testing.assert_array_equal(empty[b].numpy(), r_e)
        np.testing.assert_array_equal(empty[b].numpy(), o_empty)
        np.testing.assert_array_equal(s16[b].numpy(), r_s)
        np.testing.assert_array_equal(s16[b].numpy(), o_idx)
        np.testing.assert_allclose(cen[b].numpy(), r_c, atol=1e-5)
        np.testing.assert_allclose(cen[b].numpy()[~o_empty],
                                   centers[o_idx[~o_empty]], atol=1e-5)
        n_empty += int(o_empty.sum())
    assert 0 < n_empty < empty.numel()


def _pool_case(pool_method, seed=5):
    """A two-sample level (one world each), its voxel features and one JAX
    VoxelQueryPool with numpy-drawn variables."""
    from glenet_tpu.models.roi_heads import VoxelQueryPool as JaxPool
    cin, mid, out = 12, 16, 8
    worlds = _worlds((seed, seed + 1), 60, 30)
    rng = np.random.RandomState(seed)
    n = 64                                   # slots, 4 of them inactive
    feats = rng.randn(2, n, cin).astype(np.float32)
    mask = np.zeros((2, n), bool)
    mask[:, :60] = True
    feats[~mask] = 0
    v2p = np.stack([w[1] for w in worlds])
    grid_pts = np.stack([w[3] for w in worlds])
    pc_range = (0.0, 0.0, 0.0, 2.0, 1.6, 1.6)
    jpool = JaxPool(mlp_mid=mid, mlp_out_ch=out, query_range=vqp.QR,
                    radius=vqp.RADIUS, nsample=vqp.NSAMPLE,
                    pool_method=pool_method, grid=vqp.GRID, stride=1,
                    voxel_size=vqp.VS, pc_range=pc_range)
    args = (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(v2p),
            jnp.asarray(grid_pts))
    shapes = jax.eval_shape(lambda: jpool.init(jax.random.PRNGKey(0), *args,
                                               False))
    variables = tp.random_variables(shapes, seed=seed)
    return jpool, variables, (feats, mask, v2p, grid_pts), (cin, mid, out)


def _port_pool(pool_method, variables, widths):
    from glenet_tpu_torch.models.roi_heads import VoxelQueryPool
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    pool = VoxelQueryPool(*widths, vqp.QR, vqp.RADIUS, vqp.NSAMPLE,
                          pool_method)
    load_jax_variables(pool, variables)
    return pool


def _port_call(pool, inputs, train):
    feats, mask, v2p, grid_pts = (torch.as_tensor(a) for a in inputs)
    return pool(feats, mask, v2p, grid_pts, vqp.GRID, vqp.VS,
                (0.0, 0.0, 0.0), train)


@pytest.mark.parametrize('pool_method', ['max_pool', 'avg_pool'])
def test_voxel_query_pool_eval(pool_method):
    jpool, variables, inputs, widths = _pool_case(pool_method)
    ref = np.asarray(jpool.apply(variables, *map(jnp.asarray, inputs),
                                 False))
    with torch.no_grad():
        got = _port_call(_port_pool(pool_method, variables, widths), inputs,
                         False)
    tp.assert_close(got, ref)


@pytest.mark.parametrize('pool_method', ['max_pool', 'avg_pool'])
def test_voxel_query_pool_train(pool_method):
    """Train forward (batch moments), the BN running stats it leaves and
    the gradients of the parameters and the input features for one
    cotangent, against jax.vjp."""
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    jpool, variables, inputs, widths = _pool_case(pool_method, seed=8)
    feats = jnp.asarray(inputs[0])
    rest = tuple(map(jnp.asarray, inputs[1:]))

    def fwd(params, x):
        return jpool.apply({'params': params,
                            'batch_stats': variables['batch_stats']},
                           x, *rest, True, mutable=['batch_stats'])

    (ref, new_state), vjp = jax.vjp(fwd, variables['params'], feats)
    cot = np.random.RandomState(9).randn(*ref.shape).astype(np.float32)
    g_params, g_feats = vjp((jnp.asarray(cot),
                             jax.tree.map(jnp.zeros_like, new_state)))

    pool = _port_pool(pool_method, variables, widths)
    x = torch.from_numpy(inputs[0]).requires_grad_(True)
    got = _port_call(pool, (x,) + inputs[1:], True)
    got.backward(torch.from_numpy(cot))
    tp.assert_close(got.detach(), np.asarray(ref))
    stats = jax_tree_to_port(pool, jax.tree.map(
        np.asarray, new_state['batch_stats']), 'batch_stats')
    buffers = dict(pool.named_buffers())
    assert len(stats) == 6
    for k, v in stats.items():
        tp.assert_close(buffers[k], v, err_msg=k)
    grads = jax_tree_to_port(pool, jax.tree.map(np.asarray, g_params))
    params = dict(pool.named_parameters())
    assert set(grads) == set(params)
    for k, v in grads.items():
        tp.assert_close(params[k].grad, v, err_msg=k)
    tp.assert_close(x.grad, np.asarray(g_feats))


def _toy_cfg(dp_ratio=None):
    cfg = tp.voxel_query_cfg(tp.tiny_twostage_cfg(512))
    if dp_ratio is not None:
        cfg.MODEL.ROI_HEAD.DP_RATIO = dp_ratio
    return cfg


@pytest.fixture(scope='module')
def predicts():
    with tp.pinned_f32():
        return tp.run_predicts(_toy_cfg())


def test_toy_predict_rcnn(predicts):
    jax_full, _, full, _, _ = predicts
    np.testing.assert_array_equal(full['proposals']['roi_valid'].numpy(),
                                  jax_full['proposals']['roi_valid'])
    for k in ('rcnn_cls', 'rcnn_reg', 'rcnn_reg_std'):
        tp.assert_close(full['rcnn'][k], jax_full['rcnn'][k], err_msg=k)


def test_toy_predict(predicts):
    _, jax_pred, _, pred, _ = predicts
    tp.assert_predict_equal(pred, jax_pred)


@pytest.fixture(scope='module')
def train_steps():
    with tp.pinned_f32():
        return tp.run_train_steps(_toy_cfg(dp_ratio=0.0))


def test_toy_train_step_loss_terms(train_steps):
    ref, metrics, _, _ = train_steps
    assert ref['targets']['reg_valid_mask'].sum() > 0
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_toy_train_step_gradients(train_steps):
    ref, _, grads, tdet = train_steps
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_toy_train_step_bn_stats(train_steps):
    ref, _, _, tdet = train_steps
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])
