"""Parity of the port's BN-statistics refresh (train/bn_refresh.py) with
glenet_tpu's.

  - `refresh_batch_stats` on one synthetic sequence of per-batch moments
    (both packages invert the EMA update in float64): rtol 1e-6;
  - `refresh_detector_stats` on the toy two-stage topology with the same
    numpy-drawn weights (through jax_weights.load_jax_variables) and the
    same batches, f32 on both sides, DP_RATIO 0.  RoI sampling draws from
    each framework's own RNG, so the port is fed, per refresh batch, the
    RoI targets that the JAX refresh samples for it (its forward i draws
    from fold_in(PRNGKey(0), i)), as test_torch_train_step.py does.  Every
    BN running stat at rtol 1e-4, plus the floor that both packages'
    method sets: a refreshed stat is a batch moment recovered from an f32
    running stat by inverting the EMA update, (new - (1 - m) old) / m, so
    the two f32 roundings of `new` (half an ulp each) come back multiplied
    by 1 / m = 100: atol 2^-22 |old| / m per element (2.4e-5 where the
    drawn stat is 1, against a moment of ~0.03 at conv1_0)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

MOMENTUM = 0.01
CHANNELS = {'conv1.bn': 5, 'block.0.bn': 3, 'head.bn': 7}


def _moment_sequence(n_batches, seed=0):
    """Old stats, and per batch the stats after one EMA update from them."""
    rng = np.random.RandomState(seed)
    old = {name: (rng.randn(c).astype(np.float32),
                  rng.uniform(0.5, 1.5, c).astype(np.float32))
           for name, c in CHANNELS.items()}
    new = []
    for _ in range(n_batches):
        step = {}
        for name, (m, v) in old.items():
            bm = rng.randn(*m.shape) * 2 + 1
            bv = rng.uniform(0.1, 3.0, v.shape)
            step[name] = (((1 - MOMENTUM) * m + MOMENTUM * bm)
                          .astype(np.float32),
                          ((1 - MOMENTUM) * v + MOMENTUM * bv)
                          .astype(np.float32))
        new.append(step)
    return old, new


@pytest.mark.parametrize('n_batches', [1, 4])
def test_refresh_batch_stats(n_batches):
    from glenet_tpu.train.bn_refresh import refresh_batch_stats as jrefresh

    from glenet_tpu_torch.train.bn_refresh import refresh_batch_stats
    old, new = _moment_sequence(n_batches)

    def tree(stats):
        out = {}
        for name, (m, v) in stats.items():
            node = out
            for part in name.split('.'):
                node = node.setdefault(part, {})
            node['mean'], node['var'] = m, v
        return out

    ref = jrefresh({'params': {}, 'batch_stats': tree(old)}, range(n_batches),
                   lambda v, i: tree(new[i]), MOMENTUM)['batch_stats']

    def flat(stats):
        return {f'{name}.running_{k}': torch.from_numpy(x)
                for name, (m, v) in stats.items()
                for k, x in (('mean', m), ('var', v))}

    got = refresh_batch_stats(flat(old), range(n_batches),
                              lambda i: flat(new[i]), MOMENTUM)
    assert set(got) == set(flat(old))
    for name in CHANNELS:
        node = ref
        for part in name.split('.'):
            node = node[part]
        for k in ('mean', 'var'):
            np.testing.assert_allclose(got[f'{name}.running_{k}'].numpy(),
                                       node[k], rtol=1e-6, err_msg=name)
    assert all((v.numpy() >= 0).all() for k, v in got.items()
               if k.endswith('var'))


def test_refresh_batch_stats_without_batches():
    from glenet_tpu_torch.train.bn_refresh import refresh_batch_stats
    stats = {'bn.running_mean': torch.zeros(2),
             'bn.running_var': torch.ones(2)}
    assert refresh_batch_stats(stats, [], lambda b: stats, 0.01) is stats
    assert refresh_batch_stats({}, [1], lambda b: {}, 0.01) == {}


def _cfg():
    cfg = tp.tiny_twostage_cfg(512)
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    return cfg


def _batches(cfg, n):
    from __graft_entry__ import _make_batch
    return [{k: np.asarray(v) for k, v in _make_batch(
        2, n_points=1024, n_gt=8, seed=20 + i,
        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)).items()}
        for i in range(n)]


def test_refresh_detector_stats():
    import jax.numpy as jnp

    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.train.bn_refresh import refresh_detector_stats as jref

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train.bn_refresh import (bn_stats,
                                                   refresh_detector_stats)
    from glenet_tpu_torch.utils.jax_weights import (jax_tree_to_port,
                                                    load_jax_variables)
    cfg = _cfg()
    batches = _batches(cfg, 3)
    with tp.pinned_f32():
        det = jax_build(cfg)
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                                jax.tree.map(jnp.asarray, batches[0]))
        variables = tp.random_variables(shapes, seed=2)
        jv = jax.tree.map(jnp.asarray, variables)
        jb = [jax.tree.map(jnp.asarray, b) for b in batches]
        ref = jref(det, jv, jb)['batch_stats']

        # the RoI targets of each refresh forward of the JAX package
        @jax.jit
        def targets(bt, key):
            r_roi, r_drop = jax.random.split(key)
            out, _ = det.net.apply(
                jv, bt['points'], bt['points_mask'],
                gt_boxes=bt['gt_boxes'], gt_mask=bt['gt_mask'],
                gt_uncertainty=bt['gt_uncertainty'], train=True,
                mutable=['batch_stats'],
                rngs={'roi_sampler': r_roi, 'dropout': r_drop})
            return out['roi_targets']

        key = jax.random.PRNGKey(0)
        tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
        load_jax_variables(tdet.net, variables)
        tbatches = []
        for i, b in enumerate(jb):
            rt = targets(b, jax.random.fold_in(key, i + 1))
            tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
            tb['roi_targets'] = {k: torch.from_numpy(np.array(v))
                                 for k, v in rt.items()}
            tbatches.append(tb)
        before = {k: v.clone() for k, v in bn_stats(tdet.net).items()}
        refreshed = refresh_detector_stats(tdet, tbatches)

    ref = jax_tree_to_port(tdet.net, jax.tree.map(np.asarray, ref),
                           'batch_stats')
    live = bn_stats(tdet.net)
    assert set(ref) == set(live) == set(refreshed)
    n_moved = 0
    for k, v in ref.items():
        floor = 2.0 ** -22 * np.abs(before[k].numpy()) / MOMENTUM
        err = np.abs(live[k].numpy() - v)
        assert (err <= 1e-4 * np.abs(v) + floor).all(), (k, err.max())
        assert torch.equal(live[k], refreshed[k])
        n_moved += int(not torch.allclose(before[k], live[k]))
    # every stat moved: the refresh replaces the drawn stats by moments
    assert n_moved == len(ref)
