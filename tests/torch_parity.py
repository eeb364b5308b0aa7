"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
set of numpy-drawn weights and inputs goes through glenet_tpu and through
glenet_tpu_torch, both pinned to float32.

Importing this module gives torch one intra-op thread.  The suite runs in
pytest-xdist workers (6 on the 8 cores of the test machine), each of which
imports every test module when it collects; torch's default of one thread
per core in every worker, beside XLA's own pools, oversubscribes the cores
so far that tests/test_torch_{convergence, waymo_glenet_s, sessd_atss,
resume_msgpack}.py took 428 s on 4 workers instead of 83 s."""
from __future__ import annotations

import contextlib
import re
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


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
                 weights_seed=1, tdet=None, points=None):
    """glenet_tpu's and the port's predict on one config, with the same
    numpy-drawn weights (or `variables`) and points (or `points`, all
    valid); the port's detector is
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
    if points is not None:
        batch = dict(batch, points=jnp.asarray(points),
                     points_mask=jnp.ones(points.shape[:2], bool))
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


def jax_dropout_outputs(intermediates):
    """The captured outputs of the RoI head's flax Dropouts (auto-named
    Dropout_<i> in the order they run), in that order."""
    head = intermediates['roi_head']
    names = sorted((k for k in head if k.startswith('Dropout_')),
                   key=lambda k: int(k.split('_')[1]))
    return [np.asarray(head[k]['__call__'][0]) for k in names]


@contextlib.contextmanager
def fed_dropout(outputs):
    """The port's roi_heads.dropout replaced by JAX's draws: the i-th call
    keeps the entries the i-th JAX Dropout kept (its nonzero outputs; where
    the input is 0 both sides give 0 whatever the draw)."""
    import torch

    from glenet_tpu_torch.models import roi_heads
    masks = iter([o != 0 for o in outputs])

    def dropout(x, p, generator=None):
        keep = torch.from_numpy(next(masks))
        return torch.where(keep, x / (1.0 - p), 0.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(roi_heads, 'dropout', dropout)
        yield
    assert next(masks, None) is None, 'a JAX dropout draw went unused'


def run_train_steps(cfg, batch_size=2, n_points=1024, n_gt=8, seed=3,
                    total_steps=100, points=None, dropout=False,
                    gt_offset=(0.15,)):
    """One train step of glenet_tpu and one of the port on `cfg`, same
    numpy-drawn weights and points (or `points`, all valid), gt boxes
    `gt_offset` (added to x, y, ... in turn; by default 0.15 m in x) off
    the first 4 train-mode proposals of each sample, and the JAX
    step's own sampled RoI targets fed to the port (the RNG streams differ),
    as tests/test_torch_train_step.py does.  DP_RATIO should be 0 unless
    `dropout`: then the JAX step's dropout draws are fed to the port too
    (fed_dropout).  Returns (JAX's metrics, grads, batch_stats, targets and
    params after one step of its optimizer; the port's metrics; its
    gradients by port key; the port's detector, stepped); call inside
    pinned_f32()."""
    import flax.linen as nn
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
    if points is not None:
        batch.update(points=points,
                     points_mask=np.ones(points.shape[:2], bool))
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
        gt[b, :len(idx), :len(gt_offset)] += gt_offset
        gt[b, :len(idx), 7] = out['proposals']['roi_labels'][b, idx].numpy()
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
                train=True, mutable=['batch_stats', 'intermediates'],
                capture_intermediates=lambda mdl, _: isinstance(
                    mdl, nn.Dropout),
                rngs={'roi_sampler': r_roi, 'dropout': r_drop})
            loss, metrics = det.compute_loss(out, bt)
            return loss, (metrics, new_state, out['roi_targets'])

        grads, (metrics, new_state, targets) = jax.grad(
            loss_fn, has_aux=True)(v['params'])
        metrics['grad_norm'] = optax.global_norm(grads)
        upd, _ = tx.update(grads, tx.init(v['params']), v['params'])
        return {'metrics': metrics, 'grads': grads,
                'batch_stats': new_state['batch_stats'], 'targets': targets,
                'params': optax.apply_updates(v['params'], upd),
                'intermediates': new_state.get('intermediates', {})}

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
    draws = jax_dropout_outputs(ref['intermediates']) if dropout else []
    assert dropout == bool(draws), 'dropout draws and DP_RATIO disagree'
    with fed_dropout(draws) if dropout else contextlib.nullcontext():
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


def assert_grads_equal(grads, ref_grads, tdet, port_keys=False):
    """Per parameter max |diff| <= 2e-4 * max |grad| + 1e-6; ref_grads a
    JAX tree, or with port_keys already by port key."""
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    if not port_keys:
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


def tiny_pvrcnn_cfg():
    """tests/test_pvrcnn.py's toy PV-RCNN (make_pvrcnn_cfg: 64 keypoints,
    a 4^3 RoI grid, FCs of 32) with x_conv1 among FEATURES_SOURCE, so all
    six sources run, two radii on the raw points (multi-scale grouping),
    and the toy optimizer."""
    from glenet_tpu.config import Cfg
    from test_pvrcnn import make_pvrcnn_cfg
    cfg = make_pvrcnn_cfg()
    pfe = cfg.MODEL.PFE
    pfe.FEATURES_SOURCE = ['bev', 'x_conv1', 'x_conv2', 'x_conv3',
                           'x_conv4', 'raw_points']
    pfe.SA_LAYER['x_conv1'] = Cfg({'DOWNSAMPLE_FACTOR': 1,
                                   'MLPS': [[8, 8]], 'POOL_RADIUS': [0.6],
                                   'NSAMPLE': [8]})
    pfe.SA_LAYER['raw_points'] = Cfg({'MLPS': [[8, 8], [8, 8]],
                                      'POOL_RADIUS': [0.4, 0.8],
                                      'NSAMPLE': [8, 16]})
    cfg.OPTIMIZATION = Cfg(dict(TINY_OPTIMIZATION))
    return cfg


def tiny_pvpp_cfg(resnet=False):
    """tests/test_pvrcnn_plusplus.py's toy PV-RCNN++ (make_pvpp_cfg: a
    CenterHead RPN, 64 SPC keypoints, VectorPool over bev, x_conv3, x_conv4
    and raw_points with the RoI filters, a 3^3 RoI grid by VectorPool
    random choice, FCs of 32, DP_RATIO 0.3) with the toy optimizer; with
    `resnet` on VoxelResBackBone8x, as pv_rcnn_plusplus_resnet.yaml."""
    from glenet_tpu.config import Cfg
    from test_pvrcnn_plusplus import make_pvpp_cfg
    cfg = make_pvpp_cfg()
    if resnet:
        cfg.MODEL.BACKBONE_3D.NAME = 'VoxelResBackBone8x'
    cfg.OPTIMIZATION = Cfg(dict(TINY_OPTIMIZATION))
    return cfg


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
    and Cyclist with second.yaml's anchors and thresholds), and from
    'SECOND' second_multihead.yaml ('MULTIHEAD'), second_iou.yaml ('IOU')
    and pointpillar.yaml ('PILLAR'), each with its published
    post-processing and the toy optimizer."""
    import copy

    from glenet_tpu.config import Cfg
    from test_second import TINY_SECOND
    cfg = copy.deepcopy(TINY_SECOND)
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(TINY_RANGE)
    cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS = {
        'train': max_voxels, 'test': max_voxels}
    cfg.OPTIMIZATION = Cfg(dict(TINY_OPTIMIZATION))
    head, post = cfg.MODEL.DENSE_HEAD, cfg.MODEL.POST_PROCESSING
    if kind in THREE_CLASS_KINDS:
        cfg.CLASS_NAMES = [a[0] for a in SECOND_ANCHORS]
        head.ANCHOR_GENERATOR_CONFIG = [Cfg({
            'class_name': name, 'anchor_sizes': [size],
            'anchor_rotations': [0, 1.57], 'anchor_bottom_heights': [z],
            'align_center': False,
            'feature_map_stride': 2 if kind == 'PILLAR' else 8,
            'matched_threshold': hi, 'unmatched_threshold': lo})
            for name, size, z, hi, lo in SECOND_ANCHORS]
        THREE_CLASS_KINDS[kind](cfg)
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


def _multihead(cfg):
    """second_multihead.yaml's head on the toy trunk: a 16-channel shared
    conv, Car alone and Pedestrian with Cyclist in a second group (so one
    head predicts two classes), per-class final NMS."""
    from glenet_tpu.config import Cfg
    cfg.MODEL.DENSE_HEAD.update(
        NAME='AnchorHeadMulti', USE_MULTIHEAD=True, SEPARATE_MULTIHEAD=True,
        SHARED_CONV_NUM_FILTER=16,
        RPN_HEAD_CFGS=[Cfg({'HEAD_CLS_NAME': ['Car']}),
                       Cfg({'HEAD_CLS_NAME': ['Pedestrian', 'Cyclist']})])
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.MULTI_CLASSES_NMS = True


def _second_iou(cfg):
    """second_iou.yaml's SECONDHead on the toy trunk: 4 x 4 grid over the
    stride-8 map (whose 4 x 4 cells put most rois across its edge), FCs of
    32, toy proposal counts; DP_RATIO 0, so a train step has no random
    draw besides the RoI sampling (fed from JAX)."""
    from glenet_tpu.config import Cfg
    cfg.MODEL.NAME = 'SECONDNetIoU'
    cfg.MODEL.ROI_HEAD = Cfg({
        'NAME': 'SECONDHead', 'CLASS_AGNOSTIC': True,
        'SHARED_FC': [32, 32], 'IOU_FC': [32, 32], 'DP_RATIO': 0.0,
        'NMS_CONFIG': {
            'TRAIN': {'NMS_TYPE': 'nms_gpu', 'MULTI_CLASSES_NMS': False,
                      'NMS_PRE_MAXSIZE': 512, 'NMS_POST_MAXSIZE': 64,
                      'NMS_THRESH': 0.8},
            'TEST': {'NMS_TYPE': 'nms_gpu', 'MULTI_CLASSES_NMS': False,
                     'NMS_PRE_MAXSIZE': 256, 'NMS_POST_MAXSIZE': 32,
                     'NMS_THRESH': 0.7}},
        'ROI_GRID_POOL': {'GRID_SIZE': 4, 'IN_CHANNEL': 64,
                          'DOWNSAMPLE_RATIO': 8},
        'TARGET_CONFIG': {
            'BOX_CODER': 'ResidualCoder', 'ROI_PER_IMAGE': 32,
            'FG_RATIO': 0.5, 'SAMPLE_ROI_BY_EACH_CLASS': True,
            'CLS_SCORE_TYPE': 'roi_iou', 'CLS_FG_THRESH': 0.75,
            'CLS_BG_THRESH': 0.25, 'CLS_BG_THRESH_LO': 0.1,
            'HARD_BG_RATIO': 0.8, 'REG_FG_THRESH': 0.55},
        'LOSS_CONFIG': {'IOU_LOSS': 'BinaryCrossEntropy', 'LOSS_WEIGHTS': {
            'rcnn_iou_weight': 1.0, 'code_weights': [1.0] * 7}}})


def _pillar(cfg):
    """pointpillar.yaml's topology on the toy range: 0.5 x 0.5 x 4 m
    pillars (a 32 x 32 x 1 grid) of at most 4 points, two PFN layers (so
    the concatenating layer runs too), a stride-2 BEV backbone, anchors at
    feature_map_stride 2."""
    from glenet_tpu.config import Cfg
    proc = cfg.DATA_CONFIG.DATA_PROCESSOR[0]
    proc.VOXEL_SIZE = [0.5, 0.5, 4.0]
    proc.MAX_POINTS_PER_VOXEL = 4
    m = cfg.MODEL
    m.NAME = 'PointPillar'
    del m['BACKBONE_3D']
    m.VFE = Cfg({'NAME': 'PillarVFE', 'WITH_DISTANCE': False,
                 'USE_ABSLOTE_XYZ': True, 'USE_NORM': True,
                 'NUM_FILTERS': [16, 16]})
    m.MAP_TO_BEV = Cfg({'NAME': 'PointPillarScatter', 'NUM_BEV_FEATURES': 16})
    m.BACKBONE_2D = Cfg({'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [1, 1],
                         'LAYER_STRIDES': [2, 2], 'NUM_FILTERS': [16, 32],
                         'UPSAMPLE_STRIDES': [1, 2],
                         'NUM_UPSAMPLE_FILTERS': [16, 16]})


# the three-class kinds of tiny_single_stage_cfg and what each changes
THREE_CLASS_KINDS = {'SECOND': lambda cfg: None, 'MULTIHEAD': _multihead,
                     'IOU': _second_iou, 'PILLAR': _pillar}


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


def center_map_size(det):
    """CenterHead's heatmap size (W, H) of a detector of either package."""
    stride = int(det.model_cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG
                 .FEATURE_MAP_STRIDE)
    return det.grid_size[0] // stride, det.grid_size[1] // stride


def jax_center_targets(det, gb, gm):
    """One sample's CenterHead targets (heatmap, target boxes, cell
    indices, mask) as glenet_tpu's Detector._center_loss assigns them."""
    from glenet_tpu.models import center_head as jch
    ta = det.model_cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG
    out = jch.assign_targets_single(
        gb, gm, det.num_class, center_map_size(det),
        int(ta.FEATURE_MAP_STRIDE), det.voxel_size, det.pc_range,
        gaussian_overlap=float(ta.get('GAUSSIAN_OVERLAP', 0.1)),
        min_radius=int(ta.get('MIN_RADIUS', 2)))
    return dict(zip(CENTER_TARGETS, out))


def port_center_targets(tdet, gb, gm):
    """The port's counterpart of jax_center_targets."""
    from glenet_tpu_torch.models import center_head as tch
    ta = tdet.model_cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG
    out = tch.assign_targets_single(
        gb, gm, tdet.num_class, center_map_size(tdet),
        int(ta.FEATURE_MAP_STRIDE), tdet.voxel_size, tdet.pc_range,
        gaussian_overlap=float(ta.get('GAUSSIAN_OVERLAP', 0.1)),
        min_radius=int(ta.get('MIN_RADIUS', 2)))
    return dict(zip(CENTER_TARGETS, out))


CENTER_TARGETS = ('heatmap', 'target_boxes', 'inds', 'mask')


def jax_assign_targets(det, gb, gm, gu):
    """One sample's anchor targets as glenet_tpu's Detector.compute_loss
    picks the assigner (ATSS or axis-aligned, MATCH_HEIGHT); a CenterHead's
    targets (jax_center_targets) for a CenterPoint detector."""
    if det.is_center_head:
        return jax_center_targets(det, gb, gm)
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
            for k, v in traverse_util.flatten_dict(intermediates).items()
            if k[-1] == '__call__'}


# the two convs of a residual unit of VoxelResBackBone8x in both packages:
# `<name>a` (conv-BN-ReLU) and `<name>b` (conv-BN), after which the unit
# adds its input and applies a ReLU
RESIDUAL_HALF = re.compile(r'conv\d_\d+[ab]')


def sow_residual_operands(next_fun, args, kwargs, context):
    """A flax method interceptor (nn.intercept_methods) that sows, in
    'intermediates', each residual unit's input x (the input of its
    `<name>a` conv, as residual_x) and its `<name>b` conv's output h (as
    residual_h), the two operands of the unit's pre-ReLU sum h + x.
    flax captures module outputs only, and level 3's first unit takes the
    densified output of conv3_down, which no module returns."""
    out = next_fun(*args, **kwargs)
    mod = context.module
    if (context.method_name == '__call__'
            and RESIDUAL_HALF.fullmatch(mod.name or '')):
        if mod.name.endswith('a'):
            mod.sow('intermediates', 'residual_x', args[0])
        else:
            mod.sow('intermediates', 'residual_h',
                    out[0] if isinstance(out, tuple) else out)
    return out


def jax_residual_sums(intermediates):
    """The sown operands (sow_residual_operands) -> {port unit name, as
    `backbone_3d.conv1_0`: [JAX's pre-ReLU sum h + x of each call]}, each
    sum one f32 add of the two captured operands, as JAX rounds it."""
    from flax import traverse_util
    ops = {}
    for k, v in traverse_util.flatten_dict(intermediates).items():
        if k[-1] in ('residual_x', 'residual_h'):
            unit = '.'.join(k[:-2] + (k[-2][:-1],))
            ops.setdefault(unit, {})[k[-1]] = v
    return {unit: [np.asarray(h, np.float32) + np.asarray(x, np.float32)
                   for x, h in zip(o['residual_x'], o['residual_h'])]
            for unit, o in ops.items()}


class _Functional:
    """torch.nn.functional with its relu replaced by `relu`."""

    def __init__(self, relu):
        self.relu = relu

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)


def align_relu_kinks(net, ref_outputs, rel=1e-5, residual_sums=None):
    """Hooks on every MaskedBatchNorm of the port's `net` (each feeds a
    ReLU).  Where the port's output and JAX's (`ref_outputs`, from
    jax_bn_outputs) lie on opposite sides of 0, the port takes JAX's value
    (a shift by less than rounding, the gradient path unchanged), so both
    packages differentiate one branch of the ReLU.  Only an element whose
    two values both lie within `rel` of the module's largest |output| may
    flip; any other flip fails.

    With `residual_sums` (jax_residual_sums) the same rule holds the input
    of each residual unit's ReLU, the sum h + x of VoxelResBackBone8x's
    skip, which no BN output is: a hook on the unit's `<name>b` conv marks
    the next ReLU of glenet_tpu_torch.models.spconv_backbone as that
    unit's, and that ReLU takes JAX's side of each kink of h + x within
    `rel` of the sum's largest |value|.

    Returns (a dict whose 'flipped' counts the elements of BN sites and
    'residual_flipped' those of residual sums, 'residual_sites' the sums
    aligned; the handles, whose remove() also restores the ReLU)."""
    import types

    from glenet_tpu_torch.models import spconv_backbone as tbb
    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    seen = {'flipped': 0, 'residual_flipped': 0, 'residual_sites': 0}
    calls = {name: list(outs) for name, outs in ref_outputs.items()}

    def take_ref_side(name, y, ref, channel_dim, count):
        ref = torch.from_numpy(np.array(ref)).movedim(-1,
                                                      channel_dim % y.dim())
        assert ref.shape == y.shape, (name, ref.shape, y.shape)
        flip = (y > 0) != (ref > 0)
        if not bool(flip.any()):
            return y
        eps = rel * float(ref.abs().max())
        near = (y.abs() <= eps) & (ref.abs() <= eps)
        assert bool(near[flip].all()), (
            f'{name}: a ReLU input flips sign beyond rounding '
            f'({float((y - ref)[flip].abs().max()):.3e} > 2 x {eps:.3e})')
        seen[count] += int(flip.sum())
        return y + torch.where(flip, ref - y, 0.0).detach()

    def hook(name):
        def fn(mod, _inp, y):
            return take_ref_side(name, y, calls[name].pop(0),
                                 mod.channel_dim, 'flipped')
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in
               net.named_modules() if isinstance(m, MaskedBatchNorm)]
    assert len(handles) == len(calls) and all(n in calls for n, m in
                                              net.named_modules()
                                              if isinstance(m,
                                                            MaskedBatchNorm))
    if residual_sums is None:
        return seen, handles
    sums = {unit: list(v) for unit, v in residual_sums.items()}
    halves = {n: m for n, m in net.named_modules()
              if RESIDUAL_HALF.fullmatch(n.rsplit('.', 1)[-1])
              and n.endswith('b')}
    assert {n[:-1] for n in halves} == set(sums), (sorted(halves),
                                                   sorted(sums))
    pending = []

    def mark(unit):
        def fn(mod, _inp, _out):
            assert not pending, (pending, unit)
            pending.append((unit, mod.MaskedBatchNorm_0.channel_dim))
        return fn

    def relu(y, *args, **kwargs):
        if pending:
            unit, channel_dim = pending.pop()
            y = take_ref_side(unit, y, sums[unit].pop(0), channel_dim,
                              'residual_flipped')
            seen['residual_sites'] += 1
        return torch.nn.functional.relu(y, *args, **kwargs)

    handles += [m.register_forward_hook(mark(n[:-1]))
                for n, m in halves.items()]
    mp = pytest.MonkeyPatch()
    mp.setattr(tbb, 'F', _Functional(relu))
    handles.append(types.SimpleNamespace(remove=mp.undo))
    return seen, handles


def run_single_stage_step(cfg, batch, total_steps=100, align_relu=False):
    """One train step of glenet_tpu and one of the port's train_state on a
    single-stage `cfg` (CenterPoint too), the same numpy-drawn weights and
    `batch`.  Returns (JAX's metrics, grads, batch_stats, params after
    adam_onecycle and anchor (or CenterHead) targets; the port's metrics;
    its gradients by port key; its targets; the port's detector); call
    inside pinned_f32().  With
    align_relu, JAX's BN outputs are captured in its train forward and the
    port takes JAX's side of each ReLU kink within rounding of 0
    (align_relu_kinks), at the BN outputs and at the pre-ReLU sums of
    residual units (sow_residual_operands); their counts are
    ref['relu_flipped'] and ref['residual_flipped']."""
    import flax.linen as nn
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
    if not det.is_center_head:
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
            with (nn.intercept_methods(sow_residual_operands) if align_relu
                  else contextlib.nullcontext()):
                out, new_state = det.net.apply(
                    {'params': params, 'batch_stats': v['batch_stats']},
                    bt['points'], bt['points_mask'], gt_boxes=bt['gt_boxes'],
                    gt_mask=bt['gt_mask'],
                    gt_uncertainty=bt['gt_uncertainty'], train=True,
                    mutable=mutable, capture_intermediates=capture)
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
                'targets': (targets if det.is_center_head
                            else targets._asdict()),
                'bn_out': new_state.get('intermediates', {})}

    ref = jax.tree.map(np.asarray, jax_step(
        jax.tree.map(jnp.asarray, variables),
        jax.tree.map(jnp.asarray, batch)))
    tdet = build_detector(tcfg, device='cpu')
    load_jax_variables(tdet.net, variables)
    ttx, _ = optim.build_optimizer(tcfg.OPTIMIZATION, total_steps)
    state = st.create_train_state(tdet, ttx)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    targets = [port_center_targets(tdet, gb, gm) if tdet.is_center_head
               else tdet.assign_targets(gb, gm, gu)._asdict()
               for gb, gm, gu in zip(tbatch['gt_boxes'], tbatch['gt_mask'],
                                     tbatch['gt_uncertainty'])]
    targets = {k: torch.stack([t[k] for t in targets]).numpy()
               for k in targets[0]}
    bn_out, hooks = ref.pop('bn_out'), []
    if align_relu:
        sums = jax_residual_sums(bn_out)
        seen, hooks = align_relu_kinks(tdet.net, jax_bn_outputs(bn_out),
                                       residual_sums=sums)
    try:
        _, metrics = st.make_train_step(tdet, ttx)(state, tbatch)
    finally:
        for h in hooks:
            h.remove()
    if align_relu:
        assert seen['residual_sites'] == sum(map(len, sums.values()))
        ref['relu_flipped'] = seen['flipped']
        ref['residual_flipped'] = seen['residual_flipped']
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
    at zero thresholds (zero_thresholds).  Both packages' final-NMS
    candidates (the decoded boxes, scores, labels, log variances and
    per-class scores each predict hands its final NMS) are recorded under
    'candidates', and the port's final NMS is run on JAX's candidates
    ('fed').  Returns (JAX's {'stages', 'pred', 'pred_zero',
    'candidates'}, the port's {'full', 'pred', 'pred_zero', 'candidates',
    'fed'}, the variables); call inside pinned_f32()."""
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
        if m.backbone_3d is None:           # PointPillars
            b, v = vox['voxel_coords'].shape[:2]
            feats = m.vfe(vox['voxels'].reshape(b * v, *vox['voxels'].shape[
                2:]), vox['voxel_num_points'].reshape(b * v),
                vox['voxel_coords'].reshape(b * v, 3), train=False).reshape(
                b, v, -1)
            bev = jax.vmap(lambda f, c, k: m.map_to_bev(f, c, k, train=False))(
                feats, vox['voxel_coords'], vox['voxel_mask'])
            return {'vox': vox, 'pillars': feats, 'multi_scale': {},
                    'bev': bev, 'bev_2d': m.backbone_2d(bev, train=False)}
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

    jax_cands = record_final_nms(det, with_post=True)

    @jax.jit
    def run(v, b):
        jax_cands.clear()
        out = {'stages': det.net_eval.apply(v, b['points'], b['points_mask'],
                                            method=stages),
               'pred': det.predict(v, b),
               'pred_zero': det.predict(v, b,
                                        post_cfg=zero.MODEL.POST_PROCESSING)}
        out['candidates'] = dict(zip(PREDICT_KEYS, jax_cands))
        return out

    pb = {k: jnp.asarray(batch[k]) for k in ('points', 'points_mask')}
    ref = jax.tree.map(np.asarray, run(jax.tree.map(jnp.asarray, variables),
                                       pb))
    tdet = build_detector(to_port_cfg(cfg), device='cpu')
    load_jax_variables(tdet.net, variables)
    dets = dict(zip(PREDICT_KEYS, (tdet, build_detector(to_port_cfg(zero),
                                                         device='cpu'))))
    final_nms = {k: d._final_nms for k, d in dets.items()}
    got = {'net': tdet.net, 'candidates': {}, 'fed': {}}
    with torch.no_grad():
        got['full'] = tdet.net(torch.from_numpy(batch['points']),
                               torch.from_numpy(batch['points_mask']))
        for k, d in dets.items():
            cands = record_final_nms(d)
            got[k] = d.finalize(got['full'])
            got['candidates'][k], = cands
            fed = {n: None if v is None else torch.from_numpy(np.array(v))
                   for n, v in ref['candidates'][k].items()}
            got['fed'][k] = final_nms[k](*(fed[n] for n in CANDIDATES[:4]),
                                         cls_scores_all=fed['cls_scores'])
    return ref, got, variables


PREDICT_KEYS = ('pred', 'pred_zero')
CANDIDATES = ('boxes', 'scores', 'labels', 'std', 'cls_scores')


def record_final_nms(det, with_post=False):
    """Wrap the final NMS of `det` (a detector of either package; JAX's
    takes the post-processing config first, `with_post`) so that each call
    appends its candidates {boxes, scores, labels, std, cls_scores} to the
    returned list (JAX's as tracers, for the jitted caller to return)."""
    calls, final_nms = [], det._final_nms

    def recorded(*args, cls_scores_all=None):
        calls.append(dict(zip(CANDIDATES, args[with_post:] + (
            cls_scores_all,))))
        return final_nms(*args, cls_scores_all=cls_scores_all)

    det._final_nms = recorded
    return calls


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
    if 'backbone_3d' not in full:           # PointPillars
        _assert_pillar_stages(got['net'], full['vox'], st)
        return
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
    assert_predict_equal and rtol 1e-4 / atol 1e-5.

    Where that fails and JAX's final-NMS candidates hold a near tie
    (has_near_tie), their order is rounding's to decide, so the predict is
    held stage by stage instead: (a) the port's candidates against JAX's
    (assert_candidates_equal: a ranked list, the CenterPoint top-k, may
    trade slots only within a tie), and (b) the port's final NMS run on
    JAX's own candidates against JAX's outputs, as above, exactly."""
    ref, got, _ = predicts
    try:
        _assert_final_equal(got[key], ref[key])
    except AssertionError:
        if not has_near_tie(ref['candidates'][key]['scores']):
            raise
        traded, worst = assert_candidates_equal(got['candidates'][key],
                                                ref['candidates'][key])
        _assert_final_equal(got['fed'][key], ref[key])
        slots = ', '.join(f'({b}, {i}, {j}, {sg:.8g}, {sr:.8g})'
                          for b, i, j, sg, sr in traded)
        warnings.warn(
            f'{key}: held stage by stage at a near tie; top-k slots traded '
            f'(sample, port slot, JAX slot, port score, JAX score): '
            f'[{slots}]; largest score difference {worst:.3f} of half the '
            f'tie bound')


def _assert_final_equal(pred, ref):
    assert_predict_equal(pred, ref)
    for k in ('final_boxes', 'final_scores'):
        assert_close(pred[k], ref[k], err_msg=k)


# The order of two sigmoid scores is rounding's to decide where they lie
# within twice the most one score can differ between the packages.  Each
# package's f32 sigmoid lies within 1 ulp of the exact sigmoid of its logit
# (XLA's and torch's exp differ in the last bit), 2 ulps apart; the two
# heads' logits agree to LOGIT_ATOL, a few ulps of an O(1) logit, which
# the sigmoid's slope s (1 - s) carries into the score.
# assert_candidates_equal holds every matched score to half the bound.
LOGIT_ATOL = 2.0 ** -22


def tie_bound(s):
    """2 (2 ulp(s) + s (1 - s) LOGIT_ATOL) of f32 score(s) `s`: 6 ulps at
    s = 0.5, 8 at s = 0.4, the toy heads' range."""
    s = np.abs(np.asarray(s, np.float32))
    return 2 * (2 * np.spacing(s) + s * (1 - s) * LOGIT_ATOL)


def has_near_tie(scores):
    """Whether two live (> 0) scores of one sample of (B, N) `scores` lie
    within tie_bound of each other."""
    for row in np.asarray(scores, np.float32):
        live = np.sort(row[row > 0])[::-1]
        if np.any(live[:-1] - live[1:] <= tie_bound(live[:-1])):
            return True
    return False


def tie_runs(scores):
    """The [start, end) runs of a non-increasing (K,) score list in which
    each score lies within tie_bound of the one before it."""
    s = np.asarray(scores, np.float32)
    cut = np.flatnonzero(s[:-1] - s[1:] > tie_bound(s[:-1])) + 1
    edges = [0, *cut.tolist(), len(s)]
    return list(zip(edges[:-1], edges[1:]))


def _slot_close(a, b):
    """assert_single_stage_predict's tolerances of a final box or score,
    both at once: atol 1e-4, and rtol 1e-4 / atol 1e-5."""
    d = np.abs(a - b)
    return bool(np.all((d <= 1e-4) & (d <= 1e-5 + 1e-4 * np.abs(b))))


def assert_candidates_equal(got, ref):
    """The port's final-NMS candidates (`got`) against JAX's (`ref`), both
    {boxes (B, K, 7), scores (B, K), labels (B, K), std, cls_scores}
    (record_final_nms).  A sample whose JAX scores are not ranked (one
    candidate per anchor) compares slot by slot: labels equal, every float
    as _slot_close.  A ranked one (non-increasing scores, CenterPoint's
    top-k decode) may trade slots only within a run of JAX scores each
    within tie_bound of the one before (tie_runs): there each port slot
    must match one JAX slot of the run (label equal, box, score and log
    variances as _slot_close), except that a run ending at slot K may hold,
    for the candidates the other package cut, ones scored within
    tie_bound of JAX's last score.  Every matched score must also lie
    within half of tie_bound of JAX's, the premise of the bound.  A score
    zeroed under SCORE_THRESH on one side only fails.  Returns the traded
    slots, (sample, port slot, JAX slot, port score, JAX score) each, and
    the largest matched score difference as a share of half tie_bound."""
    got = {k: None if v is None else np.asarray(v) for k, v in got.items()}
    ref = {k: None if v is None else np.asarray(v) for k, v in ref.items()}
    assert (got['cls_scores'] is None) == (ref['cls_scores'] is None)
    if ref['cls_scores'] is not None:
        assert _slot_close(got['cls_scores'], ref['cls_scores'])
    traded, worst = [], 0.0
    for b, s_ref in enumerate(ref['scores']):
        def same(i, j):
            return (got['labels'][b, i] == ref['labels'][b, j]
                    and all(_slot_close(got[k][b, i], ref[k][b, j])
                            for k in ('boxes', 'scores', 'std')))
        if np.any(np.diff(s_ref) > 0):
            bad = [i for i in range(len(s_ref)) if not same(i, i)]
            assert not bad, f'sample {b}: candidates {bad[:8]} differ'
            continue
        s_got = got['scores'][b]
        for start, end in tie_runs(s_ref):
            free = list(range(start, end))
            for i in range(start, end):
                j = next((j for j in free if same(i, j)), None)
                if j is None:
                    assert end == len(s_ref) and abs(
                        s_got[i] - s_ref[-1]) <= tie_bound(s_ref[-1]), (
                        f'sample {b}: the port\'s candidate {i} (score '
                        f'{s_got[i]!r}) is none of JAX\'s slots '
                        f'{start}..{end - 1} (scores {s_ref[start:end]!r})')
                    continue
                free.remove(j)
                share = abs(s_got[i] - s_ref[j]) / (tie_bound(s_ref[j]) / 2)
                assert share <= 1, (
                    f'sample {b}: candidate {i}\'s score {s_got[i]!r} lies '
                    f'beyond rounding of JAX\'s {s_ref[j]!r}')
                worst = max(worst, float(share))
                if i != j:
                    traded.append((b, i, j, float(s_got[i]), float(s_ref[j])))
    return traded, worst


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


def _assert_pillar_stages(net, vox, st):
    """PointPillars' stages: the port's PillarVFE on the batch flattened
    into the pillar axis, PointPillarScatter's canvas and the 2D backbone's
    map against JAX's (rtol 1e-4 / atol 1e-5); empty canvas cells exactly
    0 on both sides."""
    import torch
    b, v = vox['voxel_coords'].shape[:2]
    with torch.no_grad():
        feats = net.vfe(vox['voxels'].flatten(0, 1),
                        vox['voxel_num_points'].flatten(0, 1),
                        vox['voxel_coords'].flatten(0, 1)).reshape(b, v, -1)
        bev = net.map_to_bev(feats, vox['voxel_coords'], vox['voxel_mask'])
        bev_2d = net.backbone_2d(bev)
    assert_close(feats, st['pillars'], err_msg='pillar features')
    assert_close(bev, st['bev'], err_msg='canvas')
    empty = ~np.asarray(st['bev'] != 0).any(-1)
    assert empty.any() and not np.asarray(bev.numpy()[empty]).any()
    assert_close(bev_2d, st['bev_2d'], err_msg='2D backbone')
