"""Parity of the port's GLENet-VR train step with glenet_tpu on the toy
two-stage topology (tiny_twostage_cfg: AnchorHeadSingle, B = 2), same
numpy-drawn weights, points and gts, f32 on both sides, DP_RATIO 0.

RoI sampling draws from framework-specific RNG streams, so the JAX step's
own sampled targets (out['roi_targets']) are fed to the port's second
stage.  The gt boxes are made from the port's train-mode proposals
(shifted 0.15 m), so the sampled rois include foreground and every RCNN
loss term is live; the scene is checked to keep every anchor's IoU at
least 1e-3 from the assigner's thresholds.

Tolerances: loss and loss terms rtol 1e-4 (atol 1e-6 for terms near 0);
gradients, per parameter, max |diff| <= 2e-4 * max |grad| + 1e-6 (f32
sums in another order through ~20 layers and a sum over ~10^4 anchors;
measured ~3e-5); BN running stats rtol 1e-4 / atol 1e-5.  Parameters after
one adam_onecycle step: the first Adam step moves each element by
lr * g / (|g| + 1e-8), about lr * sign(g), so an element whose gradient
is at the level of the sums' rounding may move either way.  Where the two
gradients agree to 1% the parameters must agree to 1e-6; elsewhere they
differ by at most the step's reach, 2 lr (1e-6 added for the decay)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

B, N_POINTS, N_GT = 2, 1024, 8
TOTAL_STEPS = 100
# train and test voxel budgets differ, as KITTI's 16000 / 40000: the step
# runs at the train budget (both budgets overflow on these scenes)
MAX_VOXELS = {'train': 448, 'test': 512}


def _cfg():
    cfg = tp.tiny_twostage_cfg(512)
    cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS = dict(MAX_VOXELS)
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    return cfg


def _batch(cfg, seed=3):
    from __graft_entry__ import _make_batch
    batch = _make_batch(B, n_points=N_POINTS, n_gt=N_GT, seed=seed,
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    return {k: np.array(v) for k, v in batch.items()}


def _gts_from_proposals(tcfg, variables, batch):
    """gt boxes at the first 4 train-mode proposals of each sample (from
    the port, on a throwaway copy: the forward updates the BN stats)."""
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    det = build_detector(tcfg, device='cpu')
    load_jax_variables(det.net, variables)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = det.net(tb['points'], tb['points_mask'], train=True,
                      gt_boxes=tb['gt_boxes'], gt_mask=tb['gt_mask'],
                      generator=torch.Generator().manual_seed(0))
    rois = out['proposals']['rois'].numpy()
    valid = out['proposals']['roi_valid'].numpy()
    gt = np.zeros((B, N_GT, 8), np.float32)
    gt_mask = np.zeros((B, N_GT), bool)
    for b in range(B):
        idx = np.flatnonzero(valid[b])[:4]
        gt[b, :len(idx), :7] = rois[b, idx]
        gt[b, :len(idx), 0] += 0.15
        gt[b, :len(idx), 7] = 1
        gt_mask[b, :len(idx)] = True
    unc = np.random.RandomState(11).uniform(0.02, 0.3, (B, N_GT, 7))
    return dict(batch, gt_boxes=gt, gt_mask=gt_mask,
                gt_uncertainty=unc.astype(np.float32))


def _assert_assigner_margin(det, batch):
    from glenet_tpu.utils import box_utils
    a = det.anchor_set
    for b in range(B):
        gts = batch['gt_boxes'][b][batch['gt_mask'][b], :7]
        iou = np.asarray(box_utils.boxes3d_nearest_bev_iou(
            a.flat_anchors, gts))
        for thr in (0.6, 0.45):
            assert np.abs(iou - thr).min() > 1e-3, 'IoU near a threshold'


@pytest.fixture(scope='module')
def runs():
    import jax.numpy as jnp
    import optax

    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.train import optim as joptim

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train import optim, state as st
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

        @jax.jit
        def jax_step(v, bt):
            # make_train_step's step 0, with the gradients and the sampled
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
            return {'metrics': metrics, 'grads': grads,
                    'batch_stats': new_state['batch_stats'],
                    'params': optax.apply_updates(v['params'], upd),
                    'targets': targets}

        ref = jax.tree.map(np.asarray, jax_step(
            jax.tree.map(jnp.asarray, variables),
            jax.tree.map(jnp.asarray, batch)))

        tdet = build_detector(tcfg, device='cpu')
        load_jax_variables(tdet.net, variables)
        ttx, _ = optim.build_optimizer(tcfg.OPTIMIZATION, TOTAL_STEPS)
        state = st.create_train_state(tdet, ttx)
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        tbatch['roi_targets'] = {k: torch.from_numpy(v)
                                 for k, v in ref['targets'].items()}
        state, metrics = st.make_train_step(tdet, ttx)(state, tbatch)
    # the step leaves each parameter's gradient in .grad
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in tdet.net.named_parameters()}
    return ref, metrics, grads, tdet


def test_targets_have_foreground(runs):
    ref = runs[0]
    assert ref['targets']['reg_valid_mask'].sum() > 0
    assert ref['metrics']['rcnn_loss_reg_square'] > 0


def test_loss_terms(runs):
    ref, metrics, _, _ = runs
    assert set(metrics) == set(ref['metrics'])
    for k, v in ref['metrics'].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_gradients(runs):
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref, _, grads, tdet = runs
    ref_grads = jax_tree_to_port(tdet.net, ref['grads'])
    assert set(ref_grads) == set(grads)
    for k, g_ref in ref_grads.items():
        g = grads[k].numpy()
        tol = 2e-4 * np.abs(g_ref).max() + 1e-6
        assert np.abs(g - g_ref).max() <= tol, (
            k, np.abs(g - g_ref).max(), tol)


def test_bn_running_stats(runs):
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref, _, _, tdet = runs
    buffers = dict(tdet.net.named_buffers())
    stats = jax_tree_to_port(tdet.net, ref['batch_stats'], 'batch_stats')
    assert len(stats) == len([k for k in tdet.net.state_dict()
                              if k.endswith(('running_mean', 'running_var'))])
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_params_after_adam(runs):
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref, _, grads, tdet = runs
    lr = 0.003 / 10                     # LR / DIV_FACTOR at step 0
    params = dict(tdet.net.named_parameters())
    ref_grads = jax_tree_to_port(tdet.net, ref['grads'])
    n_tight = 0
    for k, v in jax_tree_to_port(tdet.net, ref['params']).items():
        g, g_ref = grads[k].numpy(), ref_grads[k]
        agree = np.abs(g - g_ref) <= 1e-2 * np.abs(g_ref)
        diff = np.abs(params[k].detach().numpy() - v)
        assert diff[agree].max(initial=0) <= 1e-6, k
        assert diff.max() <= 2 * lr + 1e-6, k
        n_tight += int(agree.sum())
    assert n_tight > 0.9 * sum(p.numel() for p in params.values())


def test_train_budget():
    """The port's forward takes the train budget in train mode and the test
    budget in eval mode, with one set of parameters."""
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = _cfg()
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    det = build_detector(tp.to_port_cfg(cfg), device='cpu')
    with torch.no_grad():
        for train, budget in ((True, 'train'), (False, 'test')):
            out = det.net(tb['points'], tb['points_mask'], train=train,
                          gt_boxes=tb['gt_boxes'], gt_mask=tb['gt_mask'],
                          generator=torch.Generator().manual_seed(0))
            vox = out['vox']
            assert vox['voxel_coords'].shape[1] == MAX_VOXELS[budget]
            assert bool(vox['voxel_mask'].all())
            caps = out['backbone_3d']['multi_scale']['x_conv2']['mask'].shape
            assert caps[1] == int(3.3 * MAX_VOXELS[budget])
