"""Parity of the port's CVAE (glenet_tpu_torch/cvae/model.py) with
glenet_tpu/cvae/model.py at the full width of configs/cvae/exp_gen.yaml
(PointNet 64 / 128 / 512, decoder 64, LATENT_DIM 8), B = 4 crops of 512
points, same numpy-drawn variables (through utils/jax_weights.py) and the
same eps (JAX's draws fed to the port through cvae.model.draw_eps).

The points are dataset items of crops with fewer than 512 points,
resampled with replacement, so the max-pools see exact ties: the port's
torch.amax must split their gradient as JAX does.

Tolerances (f32 on both sides, sums over the 2048 rows of a BN and the
512-wide Dense layers in another order): forward outputs, BN stats and
loss terms rtol 1e-5, with atol 1e-5 times the largest |value| of the
tensor for elements near 0; gradients rtol 1e-4, with atol 1e-5 times the
largest |gradient| of the tensor (at least 1e-6).

A bias followed by a batch-moment BN (every Dense bias of the PointNets,
fc1, fc2, and the last BN bias of SimPointNetFeat, whose max-pool feeds
fc1) has an exact gradient of 0: the BN subtracts it again.  Both
packages return rounding noise there instead, up to 1e-6 of the largest
gradient of the encoder; the test holds each such gradient below 1e-5 of
its encoder's largest gradient.

Parameters after one make_cvae_train_step (clip at GRAD_NORM_CLIP, then
adam_onecycle): rtol 1e-6, atol 1e-7, plus what the two gradients'
difference moves the step.  The first Adam update is lr * u(c g) with
u(x) = x / (|x| + 1e-8), g the gradient and c the clip's factor, so each
element may differ by lr |u(c_port g_port) - u(c_jax g_jax)| more: the
gap of the two packages' own first steps, computed from their own
gradients and norms.  It covers the zero-gradient biases above too, whose
rounding noise the step turns into +-lr."""
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
B, LATENT = 4, 8
ANNEAL = 0.5


def _cfgs():
    from glenet_tpu.config import cfg_from_yaml_file as jcfg
    from glenet_tpu_torch.config import cfg_from_yaml_file
    path = str(ROOT / 'configs/cvae/exp_gen.yaml')
    return jcfg(path), cfg_from_yaml_file(path)


def _batch(tmp_path):
    """B training items of crops with 40-300 points (drawn with
    replacement to 512, so rows repeat)."""
    from glenet_tpu_torch.cvae.dataset import KittiGtDataset
    from glenet_tpu_torch.utils.synthetic import write_crop_database
    db = write_crop_database(tmp_path, 40, seed=2)
    _, cfg = _cfgs()
    infos = [i for i in db['Car'] if 40 <= i['num_points_in_gt'] < 300][:B]
    assert len(infos) == B
    ds = KittiGtDataset(cfg.DATA_CONFIG, training=True, root_path=tmp_path,
                        infos=infos)
    ds.rng = np.random.RandomState(5)
    batch = ds.collate([ds[i] for i in range(B)])
    for pts in batch['points']:
        assert len(np.unique(pts, axis=0)) < len(pts)
    return {k: batch[k] for k in ('points', 'gt_boxes', 'gt_boxes_input')}


def _port(variables):
    from glenet_tpu_torch.cvae.model import CVAEGenerator
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    gen = CVAEGenerator(latent_dim=LATENT, num_bins=2)
    load_jax_variables(gen, variables)
    return gen


ZERO_GRAD = re.compile(r'(PointNetFeat_0\.Dense_\d|fc1|fc2)\.bias$'
                       r'|SimPointNetFeat_0\.BatchNorm_2\.bias$')


def _close(got, want, rtol=1e-5, err_msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _eps_patch(monkeypatch, draws):
    """cvae.model.draw_eps returns `draws` in order."""
    from glenet_tpu_torch.cvae import model as tm
    it = iter(draws)

    def draw(shape, generator, device):
        e = next(it)
        assert tuple(shape) == e.shape
        return torch.from_numpy(np.array(e)).to(device)

    monkeypatch.setattr(tm, 'draw_eps', draw)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """JAX: variables, the train forward, its new BN stats, the loss terms
    and every gradient, and the variables after one train step."""
    from glenet_tpu.cvae import pipeline as jpipe
    from glenet_tpu.cvae.model import CVAEGenerator, cvae_loss
    from glenet_tpu.train import optim as joptim
    jcfg, _ = _cfgs()
    batch = _batch(tmp_path_factory.mktemp('crops'))
    gen = CVAEGenerator(latent_dim=LATENT, num_bins=2)
    shapes = jax.eval_shape(lambda: gen.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 512, 4)), jnp.zeros((B, 8)),
        jax.random.PRNGKey(1)))
    variables = tp.random_variables(shapes, seed=3)
    key = jax.random.PRNGKey(7)
    lw = jcfg.MODEL.LOSS_CONFIG.LOSS_WEIGHTS
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out, new_state = gen.apply(
            {'params': p, 'batch_stats': variables['batch_stats']},
            jb['points'], jb['gt_boxes_input'], key, train=True,
            mutable=['batch_stats'])
        reg, latent, regular, parts = cvae_loss(out, jb['gt_boxes'], p, lw)
        total = reg + ANNEAL * latent + regular
        terms = {'loss': total, 'reg_loss': reg, 'latent_loss': latent,
                 'regular_loss': regular, **parts}
        return total, (out, new_state['batch_stats'], terms)

    (_, (out, stats, terms)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    tx, _ = joptim.build_optimizer(jcfg.OPTIMIZATION, 100)
    step = jpipe.make_cvae_train_step(gen, jcfg.MODEL, tx)
    params, stats_after, _, metrics = step(
        variables['params'], variables['batch_stats'],
        tx.init(variables['params']), jb, key, ANNEAL)
    sample_key = jax.random.PRNGKey(11)
    sampled = gen.apply(variables, jb['points'], sample_key,
                        method=CVAEGenerator.sample)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {'batch': batch, 'variables': variables,
            'eps': np.asarray(jax.random.normal(key, (B, LATENT))),
            'out': to_np(out), 'stats': to_np(stats), 'terms': to_np(terms),
            'grads': to_np(grads), 'params_after': to_np(params),
            'metrics': to_np(metrics),
            'sample_eps': np.asarray(jax.random.normal(sample_key,
                                                       (B, LATENT))),
            'sampled': np.asarray(sampled)}


def _port_forward(ref, monkeypatch):
    """The port's train forward and loss terms on ref's inputs."""
    from glenet_tpu_torch.cvae.model import cvae_loss
    _, cfg = _cfgs()
    gen = _port(ref['variables'])
    _eps_patch(monkeypatch, [ref['eps']])
    tb = {k: torch.from_numpy(v) for k, v in ref['batch'].items()}
    out = gen(tb['points'], tb['gt_boxes_input'], None, train=True)
    reg, latent, regular, parts = cvae_loss(
        out, tb['gt_boxes'], list(gen.parameters()),
        cfg.MODEL.LOSS_CONFIG.LOSS_WEIGHTS)
    total = reg + ANNEAL * latent + regular
    terms = {'loss': total, 'reg_loss': reg, 'latent_loss': latent,
             'regular_loss': regular, **parts}
    return gen, out, terms


def test_variable_tree_and_init():
    """The port's parameters and buffers are exactly the JAX tree (194 808
    values at LATENT_DIM 8); build_generator initialises as flax does:
    truncated-normal kernels with std sqrt(1 / fan_in) cut at 2 std, zero
    biases, BN scale 1 / bias 0 / mean 0 / var 1."""
    from glenet_tpu.cvae.model import CVAEGenerator as JGen
    from glenet_tpu_torch.cvae.model import MaskedBatchNorm
    from glenet_tpu_torch.cvae.pipeline import build_generator
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    _, cfg = _cfgs()
    jgen = JGen(latent_dim=LATENT, num_bins=2)
    jvars = jax.jit(lambda: jgen.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 512, 4)), jnp.zeros((2, 8)),
        jax.random.PRNGKey(1)))()
    gen = build_generator(cfg.MODEL, 'cpu', seed=0)
    state = gen.state_dict()
    assert sum(t.numel() for t in state.values()) == 194_808
    mapped = {}
    for coll in ('params', 'batch_stats'):
        mapped.update(jax_tree_to_port(gen, jax.tree.map(np.asarray,
                                                         jvars[coll]), coll))
    assert set(mapped) == set(state)
    for k, v in mapped.items():
        t = state[k].numpy()
        assert t.shape == v.shape, k
        if k.endswith('.weight') and v.ndim == 2:
            std = np.sqrt(1.0 / v.shape[1])
            for w in (t, v):           # the port's draw and flax's
                assert np.abs(w).max() <= 2 * std / 0.87962566 + 1e-6, k
                if w.size >= 4096:
                    assert abs(w.std() / std - 1) < 0.05, (k, w.std(), std)
        else:
            np.testing.assert_array_equal(t, v, err_msg=k)
    # a second seed draws other weights; the same seed the same ones
    again = build_generator(cfg.MODEL, 'cpu', seed=0).state_dict()
    other = build_generator(cfg.MODEL, 'cpu', seed=1).state_dict()
    w = 'x_encoder.PointNetFeat_0.Dense_2.weight'
    assert torch.equal(again[w], state[w])
    assert not torch.equal(other[w], state[w])
    assert all(isinstance(m, MaskedBatchNorm) and m.eps == 1e-5
               for n, m in gen.named_modules() if 'BatchNorm' in n)


@pytest.mark.parametrize('key', ['box_pred_post', 'kl', 'mu_post',
                                 'logvar_post', 'mu_prior', 'logvar_prior'])
def test_train_forward(ref, monkeypatch, key):
    _, out, _ = _port_forward(ref, monkeypatch)
    _close(out[key].detach().numpy(), ref['out'][key])


def test_train_forward_bn_stats(ref, monkeypatch):
    """The BN running stats after the train forward (momentum 0.99)."""
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    gen, _, _ = _port_forward(ref, monkeypatch)
    want = jax_tree_to_port(gen, ref['stats'], 'batch_stats')
    bufs = dict(gen.named_buffers())
    assert len(want) == 22
    for k, v in want.items():
        _close(bufs[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize('key', ['loss', 'reg_loss', 'latent_loss',
                                 'regular_loss', 'loss_loc', 'loss_dir'])
def test_loss_terms(ref, monkeypatch, key):
    _, _, terms = _port_forward(ref, monkeypatch)
    np.testing.assert_allclose(float(terms[key].detach()),
                               float(ref['terms'][key]),
                               rtol=1e-5, atol=1e-6)


def test_gradients(ref, monkeypatch):
    """Every gradient of reg + 0.5 latent + regular, the max-pool ties
    included."""
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    gen, _, terms = _port_forward(ref, monkeypatch)
    terms['loss'].backward()
    want = jax_tree_to_port(gen, ref['grads'])
    params = dict(gen.named_parameters())
    assert set(want) == set(params)
    scale = {}
    for k, v in want.items():
        enc = k.split('.')[0]
        scale[enc] = max(scale.get(enc, 0.0), float(np.abs(v).max()))
    n_zero = 0
    for k, v in want.items():
        g = params[k].grad.numpy()
        if ZERO_GRAD.search(k):
            n_zero += 1
            limit = 1e-5 * scale[k.split('.')[0]]
            assert np.abs(g).max() <= limit and np.abs(v).max() <= limit, k
        else:
            np.testing.assert_allclose(
                g, v, rtol=1e-4, atol=max(1e-6, 1e-5 * np.abs(v).max()),
                err_msg=k)
    assert n_zero == 12


def test_max_pool_ties_split_the_gradient():
    """torch.amax, as JAX's max, gives each of k tied maxima 1/k of the
    gradient; torch.max(dim) would give all of it to one."""
    x = torch.tensor([[[1.0], [3.0], [3.0], [2.0]]], requires_grad=True)
    torch.amax(x, dim=1).sum().backward()
    jg = jax.grad(lambda a: a.max(axis=1).sum())(jnp.asarray(x.detach()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(x.grad.numpy().ravel(), [0, 0.5, 0.5, 0])


def test_train_step_params(ref, monkeypatch):
    """One make_cvae_train_step (forward, loss, backward, clip at
    GRAD_NORM_CLIP, adam_onecycle) against the JAX step."""
    from glenet_tpu_torch.cvae.pipeline import make_cvae_train_step
    from glenet_tpu_torch.train import optim
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    _, cfg = _cfgs()
    gen = _port(ref['variables'])
    _eps_patch(monkeypatch, [ref['eps']])
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    opt_state = tx.init(list(gen.parameters()))
    step = make_cvae_train_step(gen, cfg.MODEL, tx)
    tb = {k: torch.from_numpy(v) for k, v in ref['batch'].items()}
    metrics = step(opt_state, tb, None, ANNEAL)
    for k, v in ref['metrics'].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(metrics['grad_norm']) > float(cfg.OPTIMIZATION.GRAD_NORM_CLIP)
    params = dict(gen.named_parameters())
    lr = tx.hyperparams(0)[0]
    max_norm = float(cfg.OPTIMIZATION.GRAD_NORM_CLIP)
    grads = jax_tree_to_port(gen, ref['grads'])
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in grads.values()))
    clip_jax = min(1.0, max_norm / norm)
    clip_port = min(1.0, max_norm / float(metrics['grad_norm']))

    def first_step(g, clip):
        g = clip * g.astype(np.float64)
        return g / (np.abs(g) + 1e-8)

    for k, v in jax_tree_to_port(gen, ref['params_after']).items():
        got = params[k].detach().numpy()
        gap = np.abs(first_step(params[k].grad.numpy(), clip_port)
                     - first_step(grads[k], clip_jax))
        bound = 1e-6 * np.abs(v) + 1e-7 + lr * gap
        assert (np.abs(got - v) <= bound).all(), k


def test_optimizer_on_jax_gradients(ref):
    """The port's adam_onecycle fed JAX's own gradients gives JAX's
    parameters after the step at rtol 1e-6."""
    from glenet_tpu_torch.train import optim
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    _, cfg = _cfgs()
    gen = _port(ref['variables'])
    names, params = zip(*gen.named_parameters())
    grads = jax_tree_to_port(gen, ref['grads'])
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    opt_state = tx.init(list(params))
    tx.update(list(params), [torch.from_numpy(np.array(grads[k]))
                             for k in names], opt_state)
    for k, v in jax_tree_to_port(gen, ref['params_after']).items():
        np.testing.assert_allclose(dict(zip(names, params))[k].detach(), v,
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_sample(ref, monkeypatch):
    """Inference with JAX's eps: running-stat BN, prior z, the heading
    corrected by the direction bin."""
    gen = _port(ref['variables'])
    _eps_patch(monkeypatch, [ref['sample_eps']])
    with torch.no_grad():
        got = gen.sample(torch.from_numpy(ref['batch']['points']))
    assert got.shape == (B, 7)
    _close(got.numpy(), ref['sampled'])
