"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
set of numpy-drawn weights and inputs goes through glenet_tpu and through
glenet_tpu_torch, both pinned to float32."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest


def to_port_cfg(cfg):
    """A glenet_tpu Cfg -> the port's own Cfg (plain nested dicts)."""
    import json

    from glenet_tpu_torch.config import Cfg
    return Cfg(json.loads(json.dumps(cfg)))


def tiny_twostage_cfg(max_voxels=512):
    """The repo's toy GLENet-VR topology with GLENet-VR's dense head."""
    from __graft_entry__ import _tiny_twostage_cfg
    cfg = _tiny_twostage_cfg(max_voxels)
    cfg.MODEL.DENSE_HEAD.NAME = 'AnchorHeadSingle'
    return cfg


def random_variables(shapes, seed):
    """Numpy draws for every leaf of a JAX variables tree (a tree of arrays
    or ShapeDtypeStructs): kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1),
    BN scale / var ~ U(0.5, 1.5), BN mean ~ N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def draw(tree, leafname=None):
        if hasattr(tree, 'items'):
            return {k: draw(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        if leafname == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif leafname in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, shape)
        else:                                    # bias, mean
            v = rng.randn(*shape) * 0.1
        return v.astype(np.float32)

    return draw(shapes)


def voxel_query_cfg(cfg):
    """`cfg` with POOL_MODE voxel_query and the pool-layer settings of
    tests/test_voxel_query_pool.py (4^3 query range, 0.8 m radius, 16
    samples, max pooling)."""
    pool = cfg.MODEL.ROI_HEAD.ROI_GRID_POOL
    pool.POOL_MODE = 'voxel_query'
    for src in pool.POOL_LAYERS:
        pool.POOL_LAYERS[src].update(
            QUERY_RANGES=[[4, 4, 4]], POOL_RADIUS=[0.8], NSAMPLE=[16],
            POOL_METHOD='max_pool')
    return cfg


def plain_voxel_rcnn_cfg(cfg):
    """`cfg` turned into plain Voxel R-CNN the way voxel_rcnn_car.yaml
    differs from GLENet_VR.yaml: VoxelRCNNHead, no POST_SCORE_THRESH, final
    NMS nms_gpu."""
    cfg.MODEL.ROI_HEAD.NAME = 'VoxelRCNNHead'
    cfg.MODEL.POST_PROCESSING.pop('POST_SCORE_THRESH', None)
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_TYPE = 'nms_gpu'
    return cfg


def run_predicts(cfg, variables=None, batch_size=2, n_points=1024, seed=3,
                 weights_seed=1, tdet=None):
    """glenet_tpu's and the port's predict on one config, with the same
    numpy-drawn weights (or `variables`) and points; the port's detector is
    built and given the variables unless `tdet` is passed.  Returns (JAX's
    full forward outputs, JAX's predict, the port's full outputs, the
    port's predict, the variables); call inside pinned_f32()."""
    import jax
    import jax.numpy as jnp
    import torch

    from __graft_entry__ import _make_batch
    from glenet_tpu.models.detectors import build_detector as jax_build

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    batch = _make_batch(batch_size, n_points=n_points, seed=seed,
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    det = jax_build(cfg)
    if variables is None:
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0), batch)
        variables = random_variables(shapes, seed=weights_seed)
    batch = {k: batch[k] for k in ('points', 'points_mask')}

    @jax.jit
    def run(v, b):
        return (det.net_eval.apply(v, b['points'], b['points_mask'],
                                   train=False),
                det.predict(v, b))

    jax_full, jax_pred = jax.tree.map(np.asarray, run(
        jax.tree.map(jnp.asarray, variables), batch))
    if tdet is None:
        tdet = build_detector(to_port_cfg(cfg), device='cpu')
        load_jax_variables(tdet.net, variables)
    with torch.no_grad():
        full = tdet.net(torch.from_numpy(np.array(batch['points'])),
                        torch.from_numpy(np.array(batch['points_mask'])))
        pred = tdet.finalize(full)
    return jax_full, jax_pred, full, pred, variables


def assert_close(a, b, rtol=1e-4, atol=1e-5, err_msg=''):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def assert_predict_equal(pred, ref):
    """Valid masks and labels equal, final boxes and scores atol 1e-4."""
    assert ref['final_valid'].any(), 'the case must keep some boxes'
    np.testing.assert_array_equal(pred['final_valid'].numpy(),
                                  ref['final_valid'])
    np.testing.assert_array_equal(pred['final_labels'].numpy(),
                                  ref['final_labels'])
    assert_close(pred['final_boxes'], ref['final_boxes'], rtol=0, atol=1e-4)
    assert_close(pred['final_scores'], ref['final_scores'], rtol=0,
                 atol=1e-4)


def run_train_steps(cfg, batch_size=2, n_points=1024, n_gt=8, seed=3,
                    total_steps=100):
    """One train step of glenet_tpu and one of the port on `cfg` (DP_RATIO
    should be 0), same numpy-drawn weights and points, gt boxes 0.15 m off
    the first 4 train-mode proposals of each sample, and the JAX step's own
    sampled RoI targets fed to the port (the RNG streams differ), as
    tests/test_torch_train_step.py does.  Returns (JAX's metrics, grads,
    batch_stats and targets; the port's metrics; its gradients by port
    key; the port's detector); call inside pinned_f32()."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from __graft_entry__ import _make_batch
    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.train import optim as joptim

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train import optim, state as st
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    tcfg = to_port_cfg(cfg)
    batch = {k: np.array(v) for k, v in _make_batch(
        batch_size, n_points=n_points, n_gt=n_gt, seed=seed,
        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)).items()}
    det = jax_build(cfg)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jax.tree.map(jnp.asarray, batch))
    variables = random_variables(shapes, seed=1)

    probe = build_detector(tcfg, device='cpu')
    load_jax_variables(probe.net, variables)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = probe.net(tb['points'], tb['points_mask'], train=True,
                        gt_boxes=tb['gt_boxes'], gt_mask=tb['gt_mask'],
                        generator=torch.Generator().manual_seed(0))
    rois = out['proposals']['rois'].numpy()
    valid = out['proposals']['roi_valid'].numpy()
    gt = np.zeros((batch_size, n_gt, 8), np.float32)
    gt_mask = np.zeros((batch_size, n_gt), bool)
    for b in range(batch_size):
        idx = np.flatnonzero(valid[b])[:4]
        gt[b, :len(idx), :7] = rois[b, idx]
        gt[b, :len(idx), 0] += 0.15
        gt[b, :len(idx), 7] = 1
        gt_mask[b, :len(idx)] = True
    unc = np.random.RandomState(11).uniform(0.02, 0.3, (batch_size, n_gt, 7))
    batch = dict(batch, gt_boxes=gt, gt_mask=gt_mask,
                 gt_uncertainty=unc.astype(np.float32))
    tx, _ = joptim.build_optimizer(cfg.OPTIMIZATION, total_steps)

    @jax.jit
    def jax_step(v, bt):
        rng = jax.random.fold_in(jax.random.PRNGKey(17), 0)
        r_roi, r_drop = jax.random.split(rng)

        def loss_fn(params):
            out, new_state = det.net.apply(
                {'params': params, 'batch_stats': v['batch_stats']},
                bt['points'], bt['points_mask'], gt_boxes=bt['gt_boxes'],
                gt_mask=bt['gt_mask'], gt_uncertainty=bt['gt_uncertainty'],
                train=True, mutable=['batch_stats'],
                rngs={'roi_sampler': r_roi, 'dropout': r_drop})
            loss, metrics = det.compute_loss(out, bt)
            return loss, (metrics, new_state, out['roi_targets'])

        grads, (metrics, new_state, targets) = jax.grad(
            loss_fn, has_aux=True)(v['params'])
        metrics['grad_norm'] = optax.global_norm(grads)
        return {'metrics': metrics, 'grads': grads,
                'batch_stats': new_state['batch_stats'], 'targets': targets}

    ref = jax.tree.map(np.asarray, jax_step(
        jax.tree.map(jnp.asarray, variables), jax.tree.map(jnp.asarray,
                                                           batch)))
    tdet = build_detector(tcfg, device='cpu')
    load_jax_variables(tdet.net, variables)
    ttx, _ = optim.build_optimizer(tcfg.OPTIMIZATION, total_steps)
    state = st.create_train_state(tdet, ttx)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch['roi_targets'] = {k: torch.from_numpy(np.array(v))
                             for k, v in ref['targets'].items()}
    _, metrics = st.make_train_step(tdet, ttx)(state, tbatch)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in tdet.net.named_parameters()}
    return ref, metrics, grads, tdet


def assert_loss_terms_equal(metrics, ref):
    """Every loss term rtol 1e-4 (atol 1e-6 for terms near 0)."""
    assert set(metrics) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def assert_grads_equal(grads, ref_grads, tdet):
    """Per parameter max |diff| <= 2e-4 * max |grad| + 1e-6."""
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref_grads = jax_tree_to_port(tdet.net, ref_grads)
    assert set(ref_grads) == set(grads)
    for k, g_ref in ref_grads.items():
        g = grads[k].numpy()
        tol = 2e-4 * np.abs(g_ref).max() + 1e-6
        assert np.abs(g - g_ref).max() <= tol, (
            k, np.abs(g - g_ref).max(), tol)


def assert_bn_stats_equal(tdet, ref_stats):
    """Every BN running stat rtol 1e-4 / atol 1e-5."""
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    buffers = dict(tdet.net.named_buffers())
    stats = jax_tree_to_port(tdet.net, ref_stats, 'batch_stats')
    assert len(stats) == len([k for k in tdet.net.state_dict()
                              if k.endswith(('running_mean', 'running_var'))])
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@contextlib.contextmanager
def pinned_f32():
    """Both packages' gather and dense-level compute dtypes set to f32."""
    from glenet_tpu.models import spconv_backbone as jbb
    from glenet_tpu.ops import sparse as jsp

    from glenet_tpu_torch.models import spconv_backbone as tbb
    from glenet_tpu_torch.ops import sparse as tsp
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jsp, 'GATHER_COMPUTE_DTYPE'),
                          (jbb, 'DENSE_MXU_DTYPE'),
                          (tsp, 'GATHER_COMPUTE_DTYPE'),
                          (tbb, 'DENSE_MXU_DTYPE')):
            mp.setattr(mod, name, None)
        yield
