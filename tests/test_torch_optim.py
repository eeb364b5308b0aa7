"""Parity of the port's `adam` and `sgd` optimizers (train/optim.py) with
glenet_tpu's optax chains: the same parameters and gradients, 3 updates
behind the global-norm clip, whose gradients are scaled so that the clip
acts on some updates and not on others.

Tolerance: parameters at rtol 1e-6 (atol 1e-9 for elements near 0): the
same f32 arithmetic, with the global norm summed in another order.  The
optimizer state (Adam's moments, the momentum trace) at rtol 1e-6 of each
tensor's largest element: its elements are sums of terms of that size,
some of which cancel."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

SHAPES = [(3, 5), (7,), (2, 3, 4)]
CLIP = 1.0
# gradient scales of the three updates: global norms ~40, ~0.4, ~4
GRAD_SCALES = (10.0, 0.1, 1.0)


def _opt_cfg(name, clip=CLIP):
    from glenet_tpu.config import Cfg
    return Cfg({'OPTIMIZER': name, 'LR': 0.01, 'WEIGHT_DECAY': 0.05,
                'MOMENTUM': 0.85, 'GRAD_NORM_CLIP': clip})


def _draws(seed=0):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(s * rng.randn(*shape)).astype(np.float32) for shape in SHAPES]
             for s in GRAD_SCALES]
    return params, grads


def _run_jax(name, clip):
    import jax.numpy as jnp
    import optax

    from glenet_tpu.train import optim as joptim
    params, grads = _draws()
    tx, sched = joptim.build_optimizer(_opt_cfg(name, clip), total_steps=3)
    p = [jnp.asarray(x) for x in params]
    state = tx.init(p)
    norms = []
    for g in grads:
        g = [jnp.asarray(x) for x in g]
        norms.append(float(optax.global_norm(g)))
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
    return [np.asarray(x) for x in p], state, norms, float(sched(0))


def _run_port(name, clip):
    import torch_parity as tp

    from glenet_tpu_torch.train import optim
    params, grads = _draws()
    tx, sched = optim.build_optimizer(tp.to_port_cfg(_opt_cfg(name, clip)),
                                      total_steps=3)
    p = [torch.from_numpy(x.copy()) for x in params]
    state = tx.init(p)
    norms = [float(tx.update(p, [torch.from_numpy(x) for x in g], state))
             for g in grads]
    return [x.numpy() for x in p], state, norms, float(sched(0))


@pytest.mark.parametrize('name', ['adam', 'sgd'])
@pytest.mark.parametrize('clip', [CLIP, 0.0])
def test_optimizer_matches_optax(name, clip):
    ref_p, ref_state, ref_norms, ref_lr = _run_jax(name, clip)
    got_p, got_state, got_norms, got_lr = _run_port(name, clip)
    assert got_lr == pytest.approx(ref_lr, rel=1e-7)
    np.testing.assert_allclose(got_norms, ref_norms, rtol=1e-6)
    if clip:
        assert min(ref_norms) < clip < max(ref_norms)
    for g, r in zip(got_p, ref_p):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-9)
    # the optimizer state: Adam's moments, SGD's momentum trace
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_state)
              if np.ndim(x) > 0]
    mine = ([t.numpy() for t in got_state['mu'] + got_state['nu']]
            if name == 'adam' else [t.numpy() for t in got_state['trace']])
    assert len(leaves) == len(mine)
    assert got_state['count'] == 3
    for g in mine:
        match = [r for r in leaves if r.shape == g.shape
                 and np.allclose(g, r, rtol=0,
                                 atol=1e-6 * np.abs(r).max())]
        assert match, 'an optimizer state tensor has no counterpart in optax'


def test_parameters_move_by_the_update():
    """The first update of each optimizer, written out by hand: adamw moves
    each element by lr * (g / (|g| + eps) + wd * p); sgd by lr * (g + wd *
    p)."""
    import torch_parity as tp

    from glenet_tpu_torch.train import optim
    params, grads = _draws(1)
    g = [x * 0.01 for x in grads[1]]              # below the clip
    for name in ('adam', 'sgd'):
        tx, _ = optim.build_optimizer(tp.to_port_cfg(_opt_cfg(name)), 10)
        p = [torch.from_numpy(x.copy()) for x in params]
        tx.update(p, [torch.from_numpy(x) for x in g], tx.init(p))
        for got, p0, g0 in zip(p, params, g):
            step = (g0 / (np.abs(g0) + 1e-8) if name == 'adam' else g0)
            np.testing.assert_allclose(
                got.numpy(), p0 - 0.01 * (step + 0.05 * p0), rtol=1e-5,
                atol=1e-7)


def test_unknown_optimizer_raises():
    import torch_parity as tp

    from glenet_tpu_torch.train import optim
    with pytest.raises(NotImplementedError, match='rmsprop'):
        optim.build_optimizer(tp.to_port_cfg(_opt_cfg('rmsprop')), 10)
