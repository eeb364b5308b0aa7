"""The port's parallel layer (glenet_tpu_torch/parallel/) on gloo ranks of
this machine's CPU:

  - the BN modules' moments over 2 ranks equal the one-process moments of
    the whole batch, forward and backward;
  - the data-parallel GLENet-VR step on 2 ranks x B = 1 against
    glenet_tpu's step jitted on a 2-device mesh (mesh_lib.jit_train_step,
    tests/conftest.py's virtual devices), DP_RATIO 0 and JAX's sampled RoI
    targets fed to each rank's rows, with tests/test_torch_train_step.py's
    tolerances;
  - the (data, model) step on 2 x 2 ranks against the one-process step,
    its sharded leaves (mapped to JAX paths) those of glenet_tpu's
    param_shardings, and the checkpoint its rank 0 writes read back in one
    process;
  - iter_batches' striding, merge_results_dist and the test CLI's
    re-interleave against glenet_tpu's."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_dist as td  # noqa: E402
import torch_parity as tp  # noqa: E402
from test_torch_kitti_dataset import (  # noqa: E402,F401
    ARRAY_KEYS, _datasets, roots)

# ---------------------------------------------------------------------------
# BN moments over the ranks
# ---------------------------------------------------------------------------

BN_KINDS = ('masked', 'dense', 'deeplab')


def _bn_inputs(kind):
    rng = np.random.RandomState(4)
    shape = (4, 60, 8) if kind == 'masked' else (4, 8, 5, 6)
    x = torch.from_numpy((rng.randn(*shape) * 2 + 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    mask = torch.from_numpy(rng.rand(4, 60) > 0.3) if kind == 'masked' \
        else None
    return x, mask, w


@pytest.fixture(scope='module')
def bn_runs(tmp_path_factory):
    payload = {k: _bn_inputs(k) for k in BN_KINDS}
    ranks = td.launch('bn_case', 2, payload,
                      tmp_path_factory.mktemp('dp_bn'))
    return payload, ranks


@pytest.mark.parametrize('kind', BN_KINDS)
def test_bn_moments_over_ranks(bn_runs, kind):
    """Outputs, input gradients, BN parameter gradients (summed over the
    ranks) and running statistics equal the one-process module's on the
    whole batch; the running statistics are bit-equal across ranks."""
    payload, ranks = bn_runs
    ref = td.bn_forward_backward(kind, *payload[kind])
    for r, got in enumerate(r[kind] for r in ranks):
        rows = slice(2 * r, 2 * r + 2)
        for i, (a, b) in enumerate(zip(got, ref)):
            want = b[rows] if i < 2 else b
            np.testing.assert_allclose(a.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f'{kind} {i}')
    for a, b in zip(ranks[0][kind][4:], ranks[1][kind][4:]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the data-parallel step against glenet_tpu's on a 2-device mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_mesh_runs(tmp_path_factory):
    import jax.numpy as jnp
    import optax

    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.parallel import mesh as mesh_lib
    from glenet_tpu.train import optim as joptim
    from test_torch_train_step import (TOTAL_STEPS, _assert_assigner_margin,
                                       _batch, _cfg, _gts_from_proposals)

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables

    cfg = _cfg()
    tcfg = tp.to_port_cfg(cfg)
    batch = _batch(cfg)
    with tp.pinned_f32():
        det = jax_build(cfg)
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                                jax.tree.map(jnp.asarray, batch))
        variables = tp.random_variables(shapes, seed=1)
        batch = _gts_from_proposals(tcfg, variables, batch)
        _assert_assigner_margin(det, batch)
        tx, _ = joptim.build_optimizer(cfg.OPTIMIZATION, TOTAL_STEPS)

        def step(v, bt):
            # make_train_step's step 0 as a (state, batch) -> (state, aux)
            # function for jit_train_step, gradients and the sampled
            # targets exposed
            rng = jax.random.fold_in(jax.random.PRNGKey(17), 0)
            r_roi, r_drop = jax.random.split(rng)

            def loss_fn(params):
                out, new_state = det.net.apply(
                    {'params': params, 'batch_stats': v['batch_stats']},
                    bt['points'], bt['points_mask'],
                    gt_boxes=bt['gt_boxes'], gt_mask=bt['gt_mask'],
                    gt_uncertainty=bt['gt_uncertainty'], train=True,
                    mutable=['batch_stats'],
                    rngs={'roi_sampler': r_roi, 'dropout': r_drop})
                loss, metrics = det.compute_loss(out, bt)
                return loss, (metrics, new_state, out['roi_targets'])

            grads, (metrics, new_state, targets) = jax.grad(
                loss_fn, has_aux=True)(v['params'])
            upd, _ = tx.update(grads, tx.init(v['params']), v['params'])
            metrics['grad_norm'] = optax.global_norm(grads)
            return ({'params': optax.apply_updates(v['params'], upd),
                     'batch_stats': new_state['batch_stats']},
                    {'metrics': metrics, 'grads': grads,
                     'targets': targets})

        mesh = mesh_lib.make_mesh(jax.devices()[:2])
        new, aux = mesh_lib.jit_train_step(step, mesh)(
            jax.device_put(jax.tree.map(jnp.asarray, variables),
                           mesh_lib.replicated(mesh)),
            mesh_lib.shard_batch(jax.tree.map(jnp.asarray, batch), mesh))
        ref = jax.tree.map(np.asarray, dict(aux, **new))

        probe = build_detector(tcfg, device='cpu')
        load_jax_variables(probe.net, variables)
        fed = dict(batch, roi_targets={k: np.array(v) for k, v in
                                       ref['targets'].items()})
        ranks = td.launch('dp_cases', 2, {'cases': [
            ('GLENet-VR', tcfg, probe.net.state_dict(), fed, None)]},
            tmp_path_factory.mktemp('dp_vs_jax'))
    return ref, [r['GLENet-VR'] for r in ranks], probe.net


def test_jax_mesh_loss_terms(jax_mesh_runs):
    ref, ranks, _ = jax_mesh_runs
    assert ref['targets']['reg_valid_mask'].sum() > 0
    for got in ranks:
        td.assert_metrics(got['metrics'], {
            k: float(v) for k, v in ref['metrics'].items()})


def test_jax_mesh_gradients(jax_mesh_runs):
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref, ranks, net = jax_mesh_runs
    ref_grads = jax_tree_to_port(net, ref['grads'])
    for got in ranks:
        assert set(ref_grads) == set(got['grads'])
        for k, g_ref in ref_grads.items():
            g = got['grads'][k].numpy()
            tol = 2e-4 * np.abs(g_ref).max() + 1e-6
            assert np.abs(g - g_ref).max() <= tol, (k, np.abs(
                g - g_ref).max(), tol)


def test_jax_mesh_bn_running_stats(jax_mesh_runs):
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref, ranks, net = jax_mesh_runs
    stats = jax_tree_to_port(net, ref['batch_stats'], 'batch_stats')
    for got in ranks:
        for k, v in stats.items():
            np.testing.assert_allclose(got['buffers'][k].numpy(), v,
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in ranks[0]['buffers'].items():
        assert torch.equal(v, ranks[1]['buffers'][k]), k


def test_jax_mesh_params_after_adam(jax_mesh_runs):
    """test_torch_train_step.test_params_after_adam's rule on each rank."""
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref, ranks, net = jax_mesh_runs
    lr = 0.003 / 10                     # LR / DIV_FACTOR at step 0
    ref_grads = jax_tree_to_port(net, ref['grads'])
    for got in ranks:
        n_tight = 0
        for k, v in jax_tree_to_port(net, ref['params']).items():
            g, g_ref = got['grads'][k].numpy(), ref_grads[k]
            agree = np.abs(g - g_ref) <= 1e-2 * np.abs(g_ref)
            diff = np.abs(got['params'][k].numpy() - v)
            assert diff[agree].max(initial=0) <= 1e-6, k
            assert diff.max() <= 2 * lr + 1e-6, k
            n_tight += int(agree.sum())
        assert n_tight > 0.9 * sum(p.numel() for p in got['params'].values())


# ---------------------------------------------------------------------------
# the (data, model) step
# ---------------------------------------------------------------------------

MP = 2


@pytest.fixture(scope='module')
def dp_tp_runs(tmp_path_factory):
    from test_torch_parallel_families import CASES, two_stage_case
    tmp = tmp_path_factory.mktemp('dp_tp')
    with tp.pinned_f32():
        case = two_stage_case('GLENet-VR', CASES['GLENet-VR'])
        ref = td.reference_step(*case[1:])
        bn = ref.pop('bn_outputs')
        ranks = td.launch('dp_tp_case', 2 * MP, {
            'case': (*case, bn), 'mp': MP, 'ckpt': str(tmp / 'ckpt')}, tmp)
    return case, ref, ranks, tmp / 'ckpt'


def test_dp_tp_step(dp_tp_runs):
    """Each of the 4 ranks (data rank = rank // 2) against the one-process
    step on the B = 2 global batch; the ranks' gathered states are equal."""
    from glenet_tpu_torch.train import optim
    _, ref, ranks, _ = dp_tp_runs
    lr, b1 = ref['hyperparams']
    for r, got in enumerate(ranks):
        d = r // MP
        td.assert_step_equal(got, ref, lr, b1, optim.ADAM_B2,
                             rows=slice(d, d + 1), tag=f'rank {r}')
        for k, v in got['params'].items():
            assert torch.equal(v, ranks[0]['params'][k]), (r, k)
        for k, v in got['buffers'].items():
            assert torch.equal(v, ranks[0]['buffers'][k]), (r, k)


def test_dp_tp_sharded_leaves_match_jax(dp_tp_runs):
    """The leaves the ranks stored sharded (as 1/2 slices of their
    out-channel axis) are, by JAX path, those glenet_tpu's param_shardings
    shards on a (4, 2) virtual mesh."""
    from glenet_tpu_torch.utils.jax_weights import jax_path_and_shape
    from test_torch_parallel_families import CASES
    case, ref, ranks, _ = dp_tp_runs
    jax_sharded = _jax_sharded_paths(CASES['GLENet-VR']()[0], case[3])
    net = td.build(case[1])[0].net
    for got in ranks:
        paths = set()
        for k, shape in got['sharded'].items():
            full = ref['params'][k].shape
            path, jshape = jax_path_and_shape(net, k, full)
            paths.add(path[1:])
            assert sum(a != b for a, b in zip(shape, full)) == 1
            assert np.prod(shape) * MP == np.prod(full)
        assert paths == jax_sharded
    assert jax_sharded


def _jax_sharded_paths(cfg, batch):
    """The JAX paths of the params glenet_tpu's param_shardings shards on
    a (4, 2) mesh of the virtual devices."""
    import jax.numpy as jnp

    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.parallel import mesh as mesh_lib
    det = jax_build(cfg)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jax.tree.map(jnp.asarray, batch))
    mesh = mesh_lib.make_mesh_2d(jax.devices()[:8], mp=MP)
    shardings = mesh_lib.param_shardings(shapes['params'], mesh)
    return {tuple(getattr(k, 'key', k) for k in path)
            for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]
            if any(p is not None for p in s.spec)}


@pytest.mark.parametrize('kind', ['PartA2', 'PV-RCNN++', 'GLENet-C',
                                  'CaDDN'])
def test_param_shardings_match_jax(kind):
    """parallel.mesh.param_shardings on other families' toy configs (the
    sparse, DenseConvBN, VectorPool, SSFA transpose-conv and camera
    layouts): the sharded leaves, by JAX path, are glenet_tpu's."""
    from glenet_tpu_torch.parallel import mesh
    from glenet_tpu_torch.utils.jax_weights import jax_path_and_shape
    from test_torch_parallel_families import CASES as TWO
    from test_torch_parallel_single import CASES as ONE
    if kind in TWO:
        cfg = TWO[kind]()[0]
        batch = {k: np.array(v) for k, v in __import__(
            '__graft_entry__')._make_batch(
            2, n_points=256, seed=3,
            pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)).items()}
    else:
        cfg, batch = ONE[kind]()
    from glenet_tpu_torch.models.detectors import build_detector
    net = build_detector(tp.to_port_cfg(cfg), device='cpu').net
    got = {jax_path_and_shape(net, k, tuple(p.shape))[0][1:]
           for k in mesh.param_shardings(net, MP)
           for p in [net.get_parameter(k)]}
    assert got == _jax_sharded_paths(cfg, batch)


def test_dp_tp_checkpoint_loads_in_one_process(dp_tp_runs):
    """Rank 0's checkpoint of the gathered state restores into a
    one-process train state bit for bit."""
    from glenet_tpu_torch.train import checkpoint as ckpt_lib
    case, _, ranks, ckpt_dir = dp_tp_runs
    det, tx, state = td.build(case[1])
    path = ckpt_lib.find_latest_checkpoint(ckpt_dir)
    ckpt_lib.restore_train_state(state, ckpt_lib.load_checkpoint(path))
    for k, p in det.net.named_parameters():
        assert torch.equal(p.detach(), ranks[0]['params'][k]), k
    for k, b in det.net.named_buffers():
        assert torch.equal(b, ranks[0]['buffers'][k]), k
    names = [k for k, _ in det.net.named_parameters()]
    for name in ('mu', 'nu'):
        for k, t in zip(names, state.opt_state[name]):
            assert torch.equal(t, ranks[0]['moments'][name][k]), (name, k)
    assert state.step == 1


# ---------------------------------------------------------------------------
# the data side: striding, the result merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('rank', [0, 1])
@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_iter_batches_strided(roots, rank, mode):  # noqa: F811
    """Rank `rank` of 2: the same frames in the same batches as
    glenet_tpu's iter_batches with process_rank / process_count, over two
    epochs (train: shuffled, short batch dropped; eval: dataset order, the
    short batch wrap-padded)."""
    jds, tds = _datasets(roots, True, 3)
    kw = (dict(batch_size=1) if mode == 'train' else
          dict(batch_size=2, shuffle=False, drop_last=False))
    n = 0
    for epoch in (0, 1):
        pairs = list(zip(
            jds.iter_batches(seed=epoch, process_rank=rank,
                             process_count=2, **kw),
            tds.iter_batches(seed=epoch, process_rank=rank,
                             process_count=2, **kw), strict=True))
        for ref, got in pairs:
            assert ref['frame_id'] == got['frame_id']
            for k in ARRAY_KEYS:
                np.testing.assert_array_equal(ref[k], got[k])
        n += len(pairs)
    assert n > 0


@pytest.mark.parametrize('sizes,total', [((3, 3), 6), ((3, 2), 5),
                                         ((2, 2), 3), ((2, 2, 1), 5)])
def test_merge_results_dist(monkeypatch, sizes, total):
    """merge_results_dist and the test CLI's re-interleave of strided
    per-rank results equal glenet_tpu's (its all_gather_objects and the
    port's replaced by the same gathered parts)."""
    from glenet_tpu.parallel import distributed as jdist

    from glenet_tpu_torch.parallel import distributed as tdist
    from glenet_tpu_torch.tools.test import interleave_ranks
    parts = [[f'r{r}f{i}' for i in range(n)] for r, n in enumerate(sizes)]
    monkeypatch.setattr(jdist, 'all_gather_objects', lambda obj: parts)
    monkeypatch.setattr(tdist, 'all_gather_objects', lambda obj: parts)
    assert tdist.merge_results_dist(parts[0], total) == \
        jdist.merge_results_dist(parts[0], total)
    world = len(sizes)
    strided = [[i for i in range(total) if i % world == r]
               for r in range(world)]
    # tools/test.py's expression in glenet_tpu
    ref = [strided[i % world][i // world] for i in range(total)]
    assert interleave_ranks(strided, total) == ref == list(range(total))


def test_initialize_without_coordinator_is_a_no_op():
    from glenet_tpu_torch.parallel import distributed
    assert distributed.initialize(None, device='cpu') == torch.device('cpu')
    assert distributed.get_dist_info() == (0, 1)
    assert distributed.all_gather_objects({'a': 1}) == [{'a': 1}]
    assert distributed.data_rows() == (0, 1)
    assert distributed.global_batch(3) == 3
