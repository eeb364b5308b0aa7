"""Resuming the port's training from a glenet_tpu checkpoint
(train/jax_checkpoint.py: opt_state_from_jax, restore_train_state; the
train CLI), on the CPU.

For each optimizer of glenet_tpu/train/optim.py (adam_onecycle, adam,
sgd) glenet_tpu trains the toy GLENet-S (torch_parity's
tiny_single_stage_cfg('S')) for 3 steps, saves its train state with its own
save_checkpoint, then takes a 4th step.  The port resumes from the
.msgpack and takes the 4th step on the same batch:

  - the resumed optimizer state equals optax's (counts exactly; moments
    rtol 1e-6 through the weight bridge's layouts);
  - fed glenet_tpu's own 4th-step gradients, the port's optimizer gives
    glenet_tpu's parameters after the step at rtol 1e-6 / atol 1e-7;
  - its own 4th step gives them at rtol 1e-6 / atol 1e-7 plus the gap of
    the two packages' updates from the shared resumed state, each from its
    own gradient and clip factor: lr |u(g_port) - u(g_jax)| for Adam (u
    the bias-corrected update), lr |c_port g_port - c_jax g_jax| for SGD
    (the bound of the CVAE's first Adam step, carried to a resumed one).

The port's writer of glenet_tpu checkpoints is held byte for byte to
flax's msgpack_serialize, and its optimizer-state map to optax's layout;
the train CLI resumes from --ckpt x.msgpack and by auto-resume."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
OPTIMIZERS = ('adam_onecycle', 'adam', 'sgd')
TOTAL_STEPS = 20


def _cfg(name):
    from glenet_tpu.config import Cfg
    cfg = tp.tiny_single_stage_cfg('S')
    cfg.OPTIMIZATION = Cfg(dict(tp.TINY_OPTIMIZATION, OPTIMIZER=name,
                                MOMENTUM=0.9))
    if name != 'adam_onecycle':
        cfg.OPTIMIZATION.LR = 0.001
    return cfg


@pytest.fixture(scope='module')
def jax_runs(tmp_path_factory):
    """Per optimizer: glenet_tpu's checkpoint after 3 steps, the 4th
    batch, and its gradients and parameters of the 4th step."""
    from glenet_tpu.models.detectors import build_detector
    from glenet_tpu.train import checkpoint as ckpt_lib
    from glenet_tpu.train import optim, state as state_lib
    cfg = _cfg('adam')
    batches = [tp.single_stage_batch(cfg, seed=s) for s in range(3, 7)]
    det = build_detector(cfg)
    with tp.pinned_f32():
        variables = tp.random_variables(jax.eval_shape(
            det.init, jax.random.PRNGKey(0),
            jax.tree.map(jnp.asarray, batches[0])), seed=1)

        @jax.jit
        def grad_fn(params, batch_stats, batch):
            def loss_fn(p):
                loss, (_, new_state) = det.loss_fn(
                    {'params': p, 'batch_stats': batch_stats}, batch)
                return loss, new_state
            grads, new_state = jax.grad(loss_fn, has_aux=True)(params)
            return grads, new_state['batch_stats']

        out = {}
        for name in OPTIMIZERS:
            tx, _ = optim.build_optimizer(_cfg(name).OPTIMIZATION,
                                          TOTAL_STEPS)
            params = jax.tree.map(jnp.asarray, variables['params'])
            stats = jax.tree.map(jnp.asarray, variables['batch_stats'])
            opt_state = tx.init(params)
            for i, batch in enumerate(batches):
                b = jax.tree.map(jnp.asarray, batch)
                grads, new_stats = grad_fn(params, stats, b)
                if i == 3:
                    break
                upd, opt_state = tx.update(grads, opt_state, params)
                params, stats = optax.apply_updates(params, upd), new_stats
            ts = state_lib.TrainState(step=jnp.asarray(3, jnp.int32),
                                      params=params, batch_stats=stats,
                                      opt_state=opt_state)
            path = ckpt_lib.save_checkpoint(
                ckpt_lib.checkpoint_state(ts, 0, 3),
                tmp_path_factory.mktemp(name), 0)
            upd, opt4 = tx.update(grads, opt_state, params)
            out[name] = {
                'path': path, 'batch': batches[3],
                'grads': jax.tree.map(np.asarray, grads),
                'params': jax.tree.map(np.asarray,
                                       optax.apply_updates(params, upd)),
                'opt_state': jax.tree.map(np.asarray, opt_state)}
    return out


def _resumed(name, run):
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train import jax_checkpoint, optim
    from glenet_tpu_torch.train import state as st
    tcfg = tp.to_port_cfg(_cfg(name))
    tdet = build_detector(tcfg, device='cpu')
    tx, _ = optim.build_optimizer(tcfg.OPTIMIZATION, TOTAL_STEPS)
    ts = st.create_train_state(tdet, tx)
    jax_checkpoint.restore_train_state(
        ts, jax_checkpoint.load_checkpoint(run['path']), tx)
    return tdet, tx, ts


@pytest.mark.parametrize('name', OPTIMIZERS)
def test_resumed_state(jax_runs, name):
    """Step, counts and moments of the resumed state equal glenet_tpu's."""
    from flax import serialization

    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    run = jax_runs[name]
    tdet, tx, ts = _resumed(name, run)
    assert ts.step == 3 and ts.opt_state['count'] == 3
    ref = serialization.to_state_dict(run['opt_state'])['1']
    names = [k for k, _ in tdet.net.named_parameters()]
    if name == 'sgd':
        pairs = [('trace', ref['1']['0']['trace'])]
    else:
        adam = ref['inner_state']['0'] if name == 'adam_onecycle' \
            else ref['0']
        pairs = [('mu', adam['mu']), ('nu', adam['nu'])]
    for key, tree in pairs:
        want = jax_tree_to_port(tdet.net, tree)
        for k, t in zip(names, ts.opt_state[key]):
            np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6,
                                       atol=0, err_msg=f'{key} {k}')
    if name == 'adam_onecycle':
        lr, b1 = ts.opt_state['hyperparams']
        np.testing.assert_allclose(
            (lr, b1), (ref['hyperparams']['learning_rate'],
                       ref['hyperparams']['b1']), rtol=0)
        # the port's schedule at the resumed count (the next update's)
        lr3, b13 = tx.hyperparams(3)
        assert lr3 > 0 and 0.85 <= b13 <= 0.95


@pytest.mark.parametrize('name', OPTIMIZERS)
def test_resumed_optimizer_on_jax_gradients(jax_runs, name):
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    run = jax_runs[name]
    tdet, tx, ts = _resumed(name, run)
    names, params = zip(*tdet.net.named_parameters())
    grads = jax_tree_to_port(tdet.net, run['grads'])
    tx.update(list(params), [torch.from_numpy(grads[k]) for k in names],
              ts.opt_state)
    for k, v in jax_tree_to_port(tdet.net, run['params']).items():
        np.testing.assert_allclose(dict(zip(names, params))[k].detach(), v,
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def _update(name, tx, state, p, g, clip):
    """The 4th update of element arrays p (params), g (gradient) from the
    resumed per-tensor state, in f64."""
    g = clip * g.astype(np.float64)
    if name == 'sgd':
        return g
    b1, b2, eps = ((tx.hyperparams(3)[1], 0.99, 1e-8)
                   if name == 'adam_onecycle' else (tx.B1, tx.B2, tx.EPS))
    mu, nu = (s.astype(np.float64) for s in state)
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    return (mu / (1 - b1 ** 4)) / (np.sqrt(nu / (1 - b2 ** 4)) + eps)


@pytest.mark.parametrize('name', OPTIMIZERS)
def test_resumed_step(jax_runs, name):
    """The port's own 4th train step from the resumed state against
    glenet_tpu's."""
    from glenet_tpu_torch.train import state as st
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    run = jax_runs[name]
    tdet, tx, ts = _resumed(name, run)
    names = [k for k, _ in tdet.net.named_parameters()]
    keys = ('trace',) if name == 'sgd' else ('mu', 'nu')
    state0 = {k: [ts.opt_state[key][i].numpy().copy() for key in keys]
              for i, k in enumerate(names)}
    p0 = {k: p.detach().numpy().copy()
          for k, p in tdet.net.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in run['batch'].items()}
    with tp.pinned_f32():
        _, metrics = st.make_train_step(tdet, tx)(ts, batch)
    assert ts.step == 4 and ts.opt_state['count'] == 4
    ref_grads = jax_tree_to_port(tdet.net, run['grads'])
    norm_jax = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                           for g in ref_grads.values()))
    max_norm = float(tx.max_norm)
    clip_jax = min(1.0, max_norm / norm_jax)
    clip_port = min(1.0, max_norm / float(metrics['grad_norm']))
    lr = tx.hyperparams(3)[0] if name == 'adam_onecycle' else tx.lr
    params = dict(tdet.net.named_parameters())
    for k, v in jax_tree_to_port(tdet.net, run['params']).items():
        gap = np.abs(
            _update(name, tx, state0[k], p0[k], params[k].grad.numpy(),
                    clip_port)
            - _update(name, tx, state0[k], p0[k], ref_grads[k], clip_jax))
        bound = 1e-6 * np.abs(v) + 1e-7 + lr * gap
        assert (np.abs(params[k].detach().numpy() - v) <= bound).all(), k


def test_writer_is_flax_msgpack(jax_runs):
    """packb writes glenet_tpu's checkpoint dict byte for byte as flax's
    msgpack_serialize; the port's own export of a resumed state equals the
    checkpoint it came from and loads into glenet_tpu's TrainState."""
    from flax import serialization

    from glenet_tpu_torch.train import jax_checkpoint
    for name in OPTIMIZERS:
        run = jax_runs[name]
        raw = Path(run['path']).read_bytes()
        data = serialization.msgpack_restore(raw)
        assert jax_checkpoint.packb(data) == raw
        _, tx, ts = _resumed(name, run)
        mine = jax_checkpoint.checkpoint_state(ts, tx, 0, 3)
        back = jax_checkpoint.msgpack_restore(jax_checkpoint.packb(mine))
        flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        ref = dict(jax.tree_util.tree_flatten_with_path(data)[0])
        assert set(flat) == set(ref), name
        for k, v in ref.items():
            assert np.asarray(flat[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_allclose(flat[k], v, rtol=1e-6, atol=0,
                                       err_msg=str(k))
        serialization.from_state_dict(run['opt_state'],
                                      back['state']['opt_state'])


def test_packb_formats():
    """packb against flax's msgpack_serialize on a tree of every type a
    checkpoint can hold: numpy scalars (np.float64 subclasses float but is
    an ext type 3), ints of each width and sign, floats, str, bytes,
    bools, None, arrays of several dtypes, and dict keys out of order
    (flax sorts them)."""
    from flax import serialization

    from glenet_tpu_torch.train import jax_checkpoint
    tree = {'z': np.float64(1.5), 'b': np.float32(2), 'c': np.int64(-3),
            'd': 1.25, 'e': [0, 127, 128, 255, 65535, 2 ** 32, -1, -32, -33,
                             -128, -129, -2 ** 15 - 1, -2 ** 40],
            'f': np.arange(6, dtype=np.int32).reshape(2, 3), 'g': True,
            'h': None, 'i': 'x' * 40, 'j': {str(i): i for i in range(20)},
            'k': b'xyz' * 100, 'l': np.bool_(True),
            'm': np.zeros((3,), np.float16), 'n': [[], {}, 'a' * 300]}
    assert jax_checkpoint.packb(tree) == \
        serialization.msgpack_serialize(tree)
    back = jax_checkpoint.msgpack_restore(jax_checkpoint.packb(tree))
    assert back['z'] == 1.5 and back['j']['19'] == 19


def test_counts_must_agree(jax_runs):
    from glenet_tpu_torch.train import jax_checkpoint
    run = jax_runs['adam_onecycle']
    tdet, tx, _ = _resumed('adam_onecycle', run)
    ck = jax_checkpoint.load_checkpoint(run['path'])
    ck['state']['opt_state']['1']['count'] = np.asarray(5, np.int32)
    with pytest.raises(ValueError, match='counts'):
        jax_checkpoint.opt_state_from_jax(tdet.net, tx,
                                          ck['state']['opt_state'])


@pytest.mark.parametrize('how', ['--ckpt', 'auto-resume'])
def test_train_cli_resumes_msgpack(how, tmp_path):
    """glenet_tpu's checkpoint of the CLI test's toy GLENet-VR (3
    adam_onecycle updates, step 3) resumes the port's train CLI: the run
    starts at step 3 with the loaded weights and optimizer count, trains
    epoch 1 and writes the port's own checkpoint_epoch_1.pth at count
    5."""
    from test_torch_train_cli import _write_cfg

    from glenet_tpu.config import cfg_from_yaml_file as jcfg
    from glenet_tpu.models.detectors import build_detector as jbuild
    from glenet_tpu.train import checkpoint as ckpt_lib
    from glenet_tpu.train import optim, state as state_lib

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.tools import train
    from glenet_tpu_torch.train import checkpoint as ck
    from glenet_tpu_torch.utils import synthetic
    root = synthetic.write_kitti_tree(
        tmp_path / 'kitti', n_train=4, n_val=2, seed=3, n_points=6000,
        cars=(2, 3), x_range=(6.0, 14.0), y_half=6.0, ground_radius=20.0)
    cfg_path = _write_cfg(tmp_path, root)
    create_kitti_infos(cfg_from_yaml_file(str(cfg_path)).DATA_CONFIG,
                       ['Car'], root, root)
    synthetic.add_label_variances(root, seed=4)
    cfg = jcfg(str(cfg_path))
    det = jbuild(cfg)
    from __graft_entry__ import _make_batch
    batch = _make_batch(1, n_points=64,
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    variables = tp.random_variables(jax.eval_shape(
        det.init, jax.random.PRNGKey(0), batch), seed=7)
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 4)
    params = jax.tree.map(jnp.asarray, variables['params'])
    opt_state = tx.init(params)
    rng = np.random.RandomState(0)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.randn(*p.shape).astype(np.float32)), params)
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
    ts = state_lib.TrainState(
        step=jnp.asarray(3, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables['batch_stats']),
        opt_state=opt_state)
    out = tmp_path / 'out'
    ckpt_dir = out / 'ckpt' if how == 'auto-resume' else tmp_path / 'jax'
    path = ckpt_lib.save_checkpoint(ckpt_lib.checkpoint_state(ts, 0, 3),
                                    ckpt_dir, 0)
    argv = ['--cfg_file', str(cfg_path), '--output_dir', str(out),
            '--max_steps_per_epoch', '2', '--epochs', '2', '--device', 'cpu']
    if how == '--ckpt':
        argv += ['--ckpt', path]
    run = train.main(argv)
    assert run['start_step'] == 3
    assert [r['it'] for r in run['steps']] == [4, 5]
    saved = ck.load_checkpoint(out / 'ckpt' / 'checkpoint_epoch_1.pth')
    assert saved['step'] == 5 and saved['optimizer_state']['count'] == 5
    assert all(np.isfinite(r['loss']) for r in run['steps'])
