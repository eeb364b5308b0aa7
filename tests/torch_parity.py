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


# ---------------------------------------------------------------------------
# the single-stage SECONDNet family (GLENet-S, GLENet-C, plain SECOND)
# ---------------------------------------------------------------------------

TINY_RANGE = (0, -8, -3, 16, 8, 1)
TINY_OPTIMIZATION = {
    'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': 1, 'OPTIMIZER': 'adam_onecycle',
    'LR': 0.003, 'WEIGHT_DECAY': 0.01, 'MOMS': [0.95, 0.85],
    'PCT_START': 0.4, 'DIV_FACTOR': 10, 'GRAD_NORM_CLIP': 10}
# second.yaml's anchors and thresholds per class
SECOND_ANCHORS = [
    ('Car', [3.9, 1.6, 1.56], -1.78, 0.6, 0.45),
    ('Pedestrian', [0.8, 0.6, 1.73], -0.6, 0.5, 0.35),
    ('Cyclist', [1.76, 0.6, 1.73], -0.6, 0.5, 0.35)]


def tiny_single_stage_cfg(kind, max_voxels=512):
    """tests/test_second.py's TINY_SECOND on KITTI's z range (so the BEV
    fold has depth 2, as at full width), turned into a toy version of
    GLENet_S.yaml (kind 'S'), GLENet_C.yaml ('C': VoxelBackBone8xCiassd,
    SSFA, AnchorHeadKLLabelIoU) or second.yaml ('SECOND': Car, Pedestrian
    and Cyclist with second.yaml's anchors and thresholds), each with its
    published post-processing and the toy optimizer."""
    import copy

    from glenet_tpu.config import Cfg
    from test_second import TINY_SECOND
    cfg = copy.deepcopy(TINY_SECOND)
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(TINY_RANGE)
    cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS = {
        'train': max_voxels, 'test': max_voxels}
    cfg.OPTIMIZATION = Cfg(dict(TINY_OPTIMIZATION))
    head, post = cfg.MODEL.DENSE_HEAD, cfg.MODEL.POST_PROCESSING
    if kind == 'SECOND':
        cfg.CLASS_NAMES = [a[0] for a in SECOND_ANCHORS]
        head.ANCHOR_GENERATOR_CONFIG = [Cfg({
            'class_name': name, 'anchor_sizes': [size],
            'anchor_rotations': [0, 1.57], 'anchor_bottom_heights': [z],
            'align_center': False, 'feature_map_stride': 8,
            'matched_threshold': hi, 'unmatched_threshold': lo})
            for name, size, z, hi, lo in SECOND_ANCHORS]
        return cfg
    head.TARGET_ASSIGNER_CONFIG.NAME = 'WeightedAxisAlignedTargetAssigner'
    post.NMS_CONFIG.NMS_TYPE = 'new_nms_gpu'
    if kind == 'S':
        head.NAME = 'AnchorHeadKLLabel'
        post.POST_SCORE_THRESH = 0.3
    else:
        cfg.MODEL.BACKBONE_3D.NAME = 'VoxelBackBone8xCiassd'
        cfg.MODEL.MAP_TO_BEV.NUM_BEV_FEATURES = 128
        cfg.MODEL.BACKBONE_2D = Cfg({'NAME': 'SSFA'})
        head.NAME = 'AnchorHeadKLLabelIoU'
        head.update(PRE_CLS_THRESH=0.0, PRE_IOU_THRESH=0.0, POW=4)
        post.SCORE_THRESH = 0.055
    return cfg


def zero_thresholds(cfg):
    """A copy of `cfg` with SCORE_THRESH and POST_SCORE_THRESH at 0: every
    NMS_PRE_MAXSIZE candidate is live, whatever the weights."""
    import copy
    cfg = copy.deepcopy(cfg)
    post = cfg.MODEL.POST_PROCESSING
    post.SCORE_THRESH = 0.0
    if 'POST_SCORE_THRESH' in post:
        post.POST_SCORE_THRESH = 0.0
    return cfg


def single_stage_batch(cfg, batch_size=2, n_points=1024, n_gt=6, seed=3):
    """Toy training batch: uniform points in the range, 3 gt boxes per
    sample cycling through the config's classes, each with its anchor's
    size on its anchor's bottom height, within 0.3 m of one of its anchors'
    centres (so small classes match too), label variances in [0.02, 0.3);
    numpy arrays.  A config with 5 point features (Waymo's) gets an
    elongation column in [0, 1), drawn after everything else."""
    from glenet_tpu.models.anchors import generate_anchors
    from glenet_tpu.ops.voxelize import compute_grid_size
    x0, y0, z0, x1, y1, z1 = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    anchors = cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG
    vox = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    grid = compute_grid_size(cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                             vox.VOXEL_SIZE)
    centres = np.asarray(generate_anchors(
        anchors, grid, cfg.DATA_CONFIG.POINT_CLOUD_RANGE).anchors)[
        :, :, 0, :2].reshape(-1, 2)
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n_points, 4), np.float32)
    pts[..., 0] = rng.uniform(x0, x1, (batch_size, n_points))
    pts[..., 1] = rng.uniform(y0, y1, (batch_size, n_points))
    pts[..., 2] = rng.uniform(z0 + 0.1, z1 - 0.1, (batch_size, n_points))
    pts[..., 3] = rng.uniform(0, 1, (batch_size, n_points))
    gt = np.zeros((batch_size, n_gt, 8), np.float32)
    gt_mask = np.zeros((batch_size, n_gt), bool)
    for b in range(batch_size):
        for g in range(3):
            c = (b + g) % len(anchors)
            dx, dy, dz = anchors[c]['anchor_sizes'][0]
            zb = anchors[c]['anchor_bottom_heights'][0]
            cx, cy = centres[rng.randint(len(centres))] + rng.uniform(
                -0.3, 0.3, 2)
            gt[b, g] = [cx, cy, zb + dz / 2, dx, dy, dz, rng.uniform(-1, 1),
                        c + 1]
            gt_mask[b, g] = True
    unc = rng.uniform(0.02, 0.3, (batch_size, n_gt, 7)).astype(np.float32)
    enc = cfg.DATA_CONFIG.get('POINT_FEATURE_ENCODING', None)
    if enc is not None and len(enc['used_feature_list']) == 5:
        pts = np.concatenate([pts, rng.uniform(
            0, 1, (batch_size, n_points, 1)).astype(np.float32)], axis=2)
    return {'points': pts, 'points_mask': np.ones(pts.shape[:2], bool),
            'gt_boxes': gt, 'gt_mask': gt_mask, 'gt_uncertainty': unc}


def assert_assigner_margin(det, batch, margin=1e-3):
    """No anchor's nearest-BEV IoU (with MATCH_HEIGHT its 3D IoU) with a gt
    of its class lies within `margin` of that class's thresholds, so f32
    rounding cannot flip a target label between the packages.  ATSS's
    adaptive thresholds are held by test_torch_sessd_atss.py's own
    margin check."""
    import jax.numpy as jnp

    from glenet_tpu.ops import iou3d
    from glenet_tpu.utils import box_utils
    if det.target_assigner_name == 'ATSSTargetAssigner':
        return
    a = det.anchor_set
    anchors = np.asarray(a.anchors)
    for b in range(batch['gt_boxes'].shape[0]):
        for ci, name in enumerate(a.class_names):
            gts = batch['gt_boxes'][b][batch['gt_mask'][b]
                                       & (batch['gt_boxes'][b, :, 7]
                                          == ci + 1), :7]
            if not len(gts):
                continue
            sl = a.class_slices[ci]
            fn = (iou3d.boxes_iou3d if det.match_height
                  else box_utils.boxes3d_nearest_bev_iou)
            iou = np.asarray(fn(jnp.asarray(anchors[:, :, sl].reshape(-1, 7)),
                                jnp.asarray(gts)))
            for thr in (a.matched_thresholds[name],
                        a.unmatched_thresholds[name]):
                assert np.abs(iou - thr).min() > margin, (
                    'IoU near a threshold', name)


def jax_assign_targets(det, gb, gm, gu):
    """One sample's anchor targets as glenet_tpu's Detector.compute_loss
    picks the assigner (ATSS or axis-aligned, MATCH_HEIGHT)."""
    from glenet_tpu.models import target_assigner as jta
    if det.target_assigner_name == 'ATSSTargetAssigner':
        return jta.atss_assign_targets(det.anchor_set, gb, gm, gu,
                                       det.box_coder, topk=det.atss_topk,
                                       match_height=det.match_height)
    return jta.assign_targets(det.anchor_set, gb, gm, gu, det.box_coder,
                              match_height=det.match_height)


def jax_bn_outputs(intermediates):
    """flax's captured intermediates -> {port module name: [outputs of each
    call]} (the port names its modules after the flax tree)."""
    from flax import traverse_util
    return {'.'.join(k[:-1]): [np.asarray(o) for o in v]
            for k, v in traverse_util.flatten_dict(
                intermediates).items()}


def align_relu_kinks(net, ref_outputs, rel=1e-5):
    """Hooks on every MaskedBatchNorm of the port's `net` (each feeds a
    ReLU).  Where the port's output and JAX's (`ref_outputs`, from
    jax_bn_outputs) lie on opposite sides of 0, the port takes JAX's value
    (a shift by less than rounding, the gradient path unchanged), so both
    packages differentiate one branch of the ReLU.  Only an element whose
    two values both lie within `rel` of the module's largest |output| may
    flip; any other flip fails.  Returns (a dict whose 'flipped' counts the
    elements, the hook handles)."""
    import torch

    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    seen = {'flipped': 0}
    calls = {name: list(outs) for name, outs in ref_outputs.items()}

    def hook(name):
        def fn(mod, _inp, y):
            ref = torch.from_numpy(np.array(calls[name].pop(0))).movedim(
                -1, mod.channel_dim % y.dim())
            assert ref.shape == y.shape, (name, ref.shape, y.shape)
            flip = (y > 0) != (ref > 0)
            if not bool(flip.any()):
                return None
            eps = rel * float(ref.abs().max())
            near = (y.abs() <= eps) & (ref.abs() <= eps)
            assert bool(near[flip].all()), (
                f'{name}: a ReLU input flips sign beyond rounding '
                f'({float((y - ref)[flip].abs().max()):.3e} > 2 x {eps:.3e})')
            seen['flipped'] += int(flip.sum())
            return y + torch.where(flip, ref - y, 0.0).detach()
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in
               net.named_modules() if isinstance(m, MaskedBatchNorm)]
    assert len(handles) == len(calls) and all(n in calls for n, m in
                                              net.named_modules()
                                              if isinstance(m,
                                                            MaskedBatchNorm))
    return seen, handles


def run_single_stage_step(cfg, batch, total_steps=100, align_relu=False):
    """One train step of glenet_tpu and one of the port's train_state on a
    single-stage `cfg`, the same numpy-drawn weights and `batch`.  Returns
    (JAX's metrics, grads, batch_stats, params after adam_onecycle and
    anchor targets; the port's metrics; its gradients by port key; its
    anchor targets; the port's detector); call inside pinned_f32().  With
    align_relu, JAX's BN outputs are captured in its train forward and the
    port takes JAX's side of each ReLU kink within rounding of 0
    (align_relu_kinks); their count is ref['relu_flipped']."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.models.layers import MaskedBatchNorm as JaxBN
    from glenet_tpu.train import optim as joptim

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train import optim, state as st
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    tcfg = to_port_cfg(cfg)
    det = jax_build(cfg)
    assert_assigner_margin(det, batch)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jax.tree.map(jnp.asarray, batch))
    variables = random_variables(shapes, seed=1)
    tx, _ = joptim.build_optimizer(cfg.OPTIMIZATION, total_steps)
    mutable, capture = ['batch_stats'], False
    if align_relu:
        mutable.append('intermediates')
        capture = lambda mdl, _: isinstance(mdl, JaxBN)  # noqa: E731

    @jax.jit
    def jax_step(v, bt):
        def loss_fn(params):
            out, new_state = det.net.apply(
                {'params': params, 'batch_stats': v['batch_stats']},
                bt['points'], bt['points_mask'], gt_boxes=bt['gt_boxes'],
                gt_mask=bt['gt_mask'], gt_uncertainty=bt['gt_uncertainty'],
                train=True, mutable=mutable, capture_intermediates=capture)
            loss, metrics = det.compute_loss(out, bt)
            return loss, (metrics, new_state)

        grads, (metrics, new_state) = jax.grad(
            loss_fn, has_aux=True)(v['params'])
        upd, _ = tx.update(grads, tx.init(v['params']), v['params'])
        metrics['grad_norm'] = optax.global_norm(grads)
        targets = jax.vmap(lambda gb, gm, gu: jax_assign_targets(
            det, gb, gm, gu))(
            bt['gt_boxes'], bt['gt_mask'], bt['gt_uncertainty'])
        return {'metrics': metrics, 'grads': grads,
                'batch_stats': new_state['batch_stats'],
                'params': optax.apply_updates(v['params'], upd),
                'targets': targets._asdict(),
                'bn_out': new_state.get('intermediates', {})}

    ref = jax.tree.map(np.asarray, jax_step(
        jax.tree.map(jnp.asarray, variables),
        jax.tree.map(jnp.asarray, batch)))
    tdet = build_detector(tcfg, device='cpu')
    load_jax_variables(tdet.net, variables)
    ttx, _ = optim.build_optimizer(tcfg.OPTIMIZATION, total_steps)
    state = st.create_train_state(tdet, ttx)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    targets = [tdet.assign_targets(gb, gm, gu)._asdict()
               for gb, gm, gu in zip(tbatch['gt_boxes'], tbatch['gt_mask'],
                                     tbatch['gt_uncertainty'])]
    targets = {k: torch.stack([t[k] for t in targets]).numpy()
               for k in targets[0]}
    bn_out, hooks = ref.pop('bn_out'), []
    if align_relu:
        seen, hooks = align_relu_kinks(tdet.net, jax_bn_outputs(bn_out))
    _, metrics = st.make_train_step(tdet, ttx)(state, tbatch)
    for h in hooks:
        h.remove()
    if align_relu:
        ref['relu_flipped'] = seen['flipped']
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in tdet.net.named_parameters()}
    return ref, metrics, grads, targets, tdet


def assert_params_after_adam(tdet, ref, grads, lr):
    """The parameters after one adam_onecycle step: where the two gradients
    agree to 1% within 1e-6, elsewhere within the step's reach 2 lr (+1e-6
    for the decay), and the tight elements over 90% of all (as
    tests/test_torch_train_step.py holds them)."""
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
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


def run_single_stage_predicts(cfg, batch, variables=None):
    """glenet_tpu's and the port's forward stages and predicts on a
    single-stage `cfg`, numpy-drawn weights: at the config's thresholds and
    at zero thresholds (zero_thresholds).  Returns (JAX's {'stages',
    'pred', 'pred_zero'}, the port's {'full', 'pred', 'pred_zero'}, the
    variables); call inside pinned_f32()."""
    import functools

    import jax
    import jax.numpy as jnp
    import torch

    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.ops import voxelize as jvox

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    det = jax_build(cfg)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jax.tree.map(jnp.asarray, batch))
    if variables is None:
        variables = random_variables(shapes, seed=1)
    zero = zero_thresholds(cfg)

    def stages(m, points, pmask):
        vox = jax.vmap(functools.partial(
            jvox.voxelize, voxel_size=det.voxel_size, pc_range=det.pc_range,
            grid_size=det.grid_size, max_voxels=det.max_voxels_test,
            max_points_per_voxel=det.max_points_per_voxel))(points, pmask)
        feats = jax.vmap(lambda v, n: m.vfe(v, n, train=False))(
            vox['voxels'], vox['voxel_num_points'])
        sp = m.backbone_3d(feats, vox['voxel_coords'], vox['voxel_mask'],
                           train=False)
        ms = {k: {f: sp['multi_scale'][k][f]
                  for f in ('features', 'ids', 'mask', 'occ')
                  if f in sp['multi_scale'][k]}
              for k in sp['multi_scale']}
        return {'vox': vox, 'multi_scale': ms, 'bev': sp['bev_features'],
                'bev_2d': m.backbone_2d(sp['bev_features'], train=False)}

    @jax.jit
    def run(v, b):
        return {'stages': det.net_eval.apply(v, b['points'],
                                             b['points_mask'],
                                             method=stages),
                'pred': det.predict(v, b),
                'pred_zero': det.predict(v, b,
                                         post_cfg=zero.MODEL.POST_PROCESSING)}

    pb = {k: jnp.asarray(batch[k]) for k in ('points', 'points_mask')}
    ref = jax.tree.map(np.asarray, run(jax.tree.map(jnp.asarray, variables),
                                       pb))
    tdet = build_detector(to_port_cfg(cfg), device='cpu')
    load_jax_variables(tdet.net, variables)
    with torch.no_grad():
        full = tdet.net(torch.from_numpy(batch['points']),
                        torch.from_numpy(batch['points_mask']))
        got = {'full': full, 'pred': tdet.finalize(full),
               'pred_zero': build_detector(to_port_cfg(zero),
                                           device='cpu').finalize(full)}
    return ref, got, variables


def single_stage_slice(kind):
    """The toy config of `kind` (tiny_single_stage_cfg), its batch, both
    packages' predicts and one train step of each (see
    run_single_stage_predicts / run_single_stage_step), f32 pinned."""
    cfg = tiny_single_stage_cfg(kind)
    batch = single_stage_batch(cfg)
    with pinned_f32():
        predicts = run_single_stage_predicts(cfg, batch)
        step = run_single_stage_step(cfg, batch)
    return cfg, batch, predicts, step


def assert_single_stage_stages(predicts):
    """Voxels and every backbone level (ids, masks, occupancy exactly;
    features rtol 1e-4 / atol 1e-5), the BEV map, the 2D backbone's map and
    every dense-head output."""
    ref, got, _ = predicts
    st, full = ref['stages'], got['full']
    for k in ('voxel_coords', 'voxel_mask', 'voxel_num_points'):
        np.testing.assert_array_equal(full['vox'][k].numpy(), st['vox'][k])
    ms = full['backbone_3d']['multi_scale']
    assert sorted(ms) == sorted(st['multi_scale'])
    for lvl, fields in st['multi_scale'].items():
        for f, v in fields.items():
            if f == 'features':
                assert_close(ms[lvl][f], v, err_msg=f'{lvl} {f}')
            else:
                np.testing.assert_array_equal(ms[lvl][f].numpy(), v,
                                              err_msg=f'{lvl} {f}')
    assert_close(full['backbone_3d']['bev_features'], st['bev'])


def assert_single_stage_predict(predicts, key):
    """Final boxes, scores, labels and valid flags of one predict (the
    config's thresholds or zero thresholds): integers equal, floats as
    assert_predict_equal and rtol 1e-4 / atol 1e-5."""
    ref, got, _ = predicts
    assert_predict_equal(got[key], ref[key])
    for k in ('final_boxes', 'final_scores'):
        assert_close(got[key][k], ref[key][k], err_msg=k)


def assert_single_stage_targets(step):
    """The anchor targets: labels exactly, box targets and label
    variances rtol 1e-4 / atol 1e-5, with positives in every class."""
    ref, _, _, targets, tdet = step
    labels = ref['targets']['box_cls_labels']
    np.testing.assert_array_equal(targets['box_cls_labels'], labels)
    assert set(np.unique(labels[labels > 0])) == set(
        range(1, len(tdet.anchor_set.class_names) + 1))
    for k in ('box_reg_targets', 'label_uncertainty', 'reg_weights'):
        assert_close(targets[k], ref['targets'][k], err_msg=k)
