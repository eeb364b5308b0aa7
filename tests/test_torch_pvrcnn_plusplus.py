"""Parity of the port's PV-RCNN++ (MODEL.NAME PVRCNNPlusPlus: a CenterHead
RPN whose proposals come before the keypoints, SPC keypoints, VectorPool
aggregation of each source's points near a RoI, PointHeadSimple and
PVRCNNHead with VectorPool RoI-grid pooling) with glenet_tpu, on the CPU,
same numpy-drawn weights and points, f32 on both sides, on its toy version
(torch_parity.tiny_pvpp_cfg):

  - configs/waymo_models/pv_rcnn_plusplus.yaml and _resnet.yaml build at
    full width;
  - VoxelSetAbstraction alone on given rois, also in a scene whose SPC
    mask is empty (every roi invalid, or every roi far from the points):
    keypoint indices exactly, the features before and after fusion rtol
    1e-4 / atol 1e-5;
  - PVRCNNHead alone with the RoI-grid VectorPool: eval and train mode
    (DP_RATIO 0) outputs and BN running stats rtol 1e-4 / atol 1e-5;
  - a predict: keypoints, proposals, final labels and valid flags exactly;
    keypoint logits, RCNN outputs and rois rtol 1e-4 / atol 1e-5, final
    boxes and scores also atol 1e-4; every keypoint lies within
    SAMPLE_RADIUS_WITH_ROI of a proposal;
  - one train step with JAX's RoI sampling and dropout draws fed to the
    port: every loss term rtol 1e-4, every gradient per tensor max |diff|
    <= 2e-4 max |grad| + 1e-6, BN running stats rtol 1e-4 / atol 1e-5 and
    the parameters after adam_onecycle (torch_parity.
    assert_params_after_adam);
  - a glenet_tpu .msgpack of those weights predicts through the port's
    reader as glenet_tpu does;
  - the resnet yaml's toy (VoxelResBackBone8x): a predict as above;
  - plain PVRCNN refuses SPC and the RoI filters (its keypoints come
    before the proposals);
  - `tools.train`, `tools.test` and `tools.demo` on a toy PV-RCNN++ over
    a synthetic Waymo tree."""
import copy
import functools
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the gts' offset from the proposals they are made from, in every code (a
# CenterHead proposal decodes its own regression: a gt equal to it puts the
# L1 loss on its kink)
GT_OFFSET = (0.15, -0.1, 0.12, 0.2, -0.1, 0.15, 0.05)


@pytest.mark.parametrize('name,residual', [
    ('pv_rcnn_plusplus.yaml', False), ('pv_rcnn_plusplus_resnet.yaml', True)])
def test_yaml_builds(name, residual):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(cfg_from_yaml_file(
        str(ROOT / 'configs/waymo_models' / name)), device='cpu')
    net = det.net
    assert net.pvpp and det.is_center_head
    assert net.backbone_3d.residual == residual and net.backbone_3d.site_lists
    pfe = net.pfe
    assert pfe.num_keypoints == 4096 and pfe.spc_radius == 1.6
    assert pfe.aggregators == {'raw_points': ('vp_raw_points', 2.4),
                               'x_conv3': ('vp_x_conv3', 4.0),
                               'x_conv4': ('vp_x_conv4', 6.4)}
    # Waymo's raw points carry 2 features; the levels reduce to 32
    assert pfe.vp_raw_points.group_0.separate_w.shape == (8, 2 + 9, 32)
    assert pfe.vp_raw_points.group_1.separate_w.shape == (27, 2 + 9, 32)
    assert pfe.vp_x_conv4.group_1.separate_w.shape == (27, 32 + 9, 32)
    assert pfe.num_features_before_fusion == 256 + 32 + 128 + 128
    assert net.point_head_simple.cls_0.weight.shape == (256, 544)
    pool = net.roi_head.roi_grid_vpool
    assert pool.group_0.separate_w.shape == (27, 30 + 3, 32)
    assert pool.group_1.nsample == 32 and not pool.group_1.interp
    assert net.roi_head.shared_0.weight.shape == (256, 128 * 216)


def _vsa_rois(kind):
    """Rois for the VSA test: scene 0 six near the toy points (two
    invalid); scene 1 none usable ('invalid': all invalid; 'far': valid but
    40 m out of range), so its SPC mask is empty."""
    rng = np.random.RandomState(31)
    rois = np.zeros((2, 6, 7), np.float32)
    rois[..., 0] = rng.uniform(2, 14, (2, 6))
    rois[..., 1] = rng.uniform(-6, 6, (2, 6))
    rois[..., 2] = rng.uniform(-0.5, 0.5, (2, 6))
    rois[..., 3:6] = rng.uniform(0.5, 3.0, (2, 6, 3))
    rois[..., 6] = rng.uniform(-3, 3, (2, 6))
    valid = np.ones((2, 6), bool)
    valid[0, 4:] = False
    if kind == 'invalid':
        valid[1] = False
    else:
        rois[1, :, 0] += 40.0
    return rois, valid


@pytest.fixture(scope='module')
def cfg():
    return tp.tiny_pvpp_cfg()


@pytest.mark.parametrize('kind', ['invalid', 'far'])
def test_vsa_with_spc_and_roi_filters(cfg, kind):
    """The toy's VoxelSetAbstraction (eval mode) on its backbone's levels
    and given rois."""
    from __graft_entry__ import _make_batch
    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.ops import voxelize as jvox
    from glenet_tpu.models import vector_pool as jvp

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    batch = _make_batch(2, n_points=1024, seed=3,
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    pts, pmask = np.asarray(batch['points']), np.asarray(batch['points_mask'])
    rois, roi_valid = _vsa_rois(kind)
    det = jax_build(cfg)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0), batch)
    variables = tp.random_variables(shapes, seed=1)

    def vsa(m, points, mask, r, rv):
        vox = jax.vmap(functools.partial(
            jvox.voxelize, voxel_size=det.voxel_size, pc_range=det.pc_range,
            grid_size=det.grid_size, max_voxels=det.max_voxels_test,
            max_points_per_voxel=det.max_points_per_voxel))(points, mask)
        feats = jax.vmap(lambda v, n: m.vfe(v, n, train=False))(
            vox['voxels'], vox['voxel_num_points'])
        sp = m.backbone_3d(feats, vox['voxel_coords'], vox['voxel_mask'],
                           train=False)
        out = m.pfe(points, mask, sp['multi_scale'], sp['bev_features'],
                    bev_stride=8, rois=r, roi_valid=rv, train=False)
        spc = jax.vmap(lambda p, pm, rr, vv: jvp.sample_points_with_roi_mask(
            p, pm, rr, vv, 1.6))(points[..., :3], mask, r, rv)
        return out, spc

    with tp.pinned_f32():
        ref, spc = jax.tree.map(np.asarray, jax.jit(
            lambda v, *a: det.net_eval.apply(v, *a, method=vsa))(
            jax.tree.map(jnp.asarray, variables), pts, pmask, rois,
            roi_valid))
        tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
        load_jax_variables(tdet.net, variables)
        net = tdet.net
        tpts, tmask = torch.from_numpy(pts), torch.from_numpy(pmask)
        with torch.no_grad():
            vox = net.voxelize(tpts, tmask, net.max_voxels_test)
            sp = net.backbone_3d(net.vfe(vox['voxels'],
                                         vox['voxel_num_points']),
                                 vox['voxel_coords'], vox['voxel_mask'])
            got = net.pfe(tpts, tmask, sp['multi_scale'],
                          sp['bev_features'], 8, torch.from_numpy(rois),
                          torch.from_numpy(roi_valid))
    # scene 0 samples near its rois, scene 1 falls back to every point
    assert 0 < spc[0].sum() < pmask[0].sum() and not spc[1].any()
    idx = got['keypoint_idx'].numpy()
    assert spc[0][idx[0]].all()
    kp = pts[np.arange(2)[:, None], idx, :3]
    np.testing.assert_array_equal(kp, ref['keypoints'])
    np.testing.assert_array_equal(got['keypoints'].numpy(), ref['keypoints'])
    for k in ('point_features_before_fusion', 'point_features'):
        tp.assert_close(got[k], ref[k], err_msg=k)


def test_pvrcnn_head_vector_pool(cfg):
    """PVRCNNHead with ROI_GRID_POOL VectorPoolAggregationModuleMSG alone,
    eval and train mode (DP_RATIO 0), on numpy-drawn rois, keypoints and
    keypoint features."""
    from glenet_tpu.models import roi_heads as jroi

    from glenet_tpu_torch.models.roi_heads import PVRCNNHead
    from glenet_tpu_torch.utils.jax_weights import (jax_tree_to_port,
                                                    load_jax_variables)
    roi_cfg = copy.deepcopy(cfg.MODEL.ROI_HEAD)
    roi_cfg.DP_RATIO = 0.0
    rng = np.random.RandomState(41)
    kp = np.zeros((2, 64, 3), np.float32)
    kp[..., 0] = rng.uniform(2, 14, (2, 64))
    kp[..., 1] = rng.uniform(-6, 6, (2, 64))
    kp[..., 2] = rng.uniform(-1, 1, (2, 64))
    feats = rng.randn(2, 64, 32).astype(np.float32)
    rois = np.zeros((2, 5, 7), np.float32)
    rois[..., :3] = kp[:, :5] + rng.uniform(-0.3, 0.3, (2, 5, 3))
    rois[..., 3:6] = rng.uniform(1.0, 4.0, (2, 5, 3))
    rois[..., 6] = rng.uniform(-3, 3, (2, 5))
    mod = jroi.PVRCNNHead(model_cfg=dict(roi_cfg))
    shapes = jax.eval_shape(lambda k: mod.init(k, rois, kp, feats,
                                               train=False),
                            jax.random.PRNGKey(0))
    variables = tp.random_variables(shapes, seed=42)
    run = jax.jit(lambda v, r, k, f: (
        mod.apply(v, r, k, f, train=False),
        mod.apply(v, r, k, f, train=True, mutable=['batch_stats'])))
    ref_eval, (ref_train, state) = jax.tree.map(np.asarray, run(
        jax.tree.map(jnp.asarray, variables), rois, kp, feats))
    head = PVRCNNHead(tp.to_port_cfg(roi_cfg), 32)
    load_jax_variables(head, variables)
    args = [torch.from_numpy(x) for x in (rois, kp, feats)]
    with torch.no_grad():
        got_eval = head(*args, train=False)
        got_train = head(*args, train=True)
    for got, ref in ((got_eval, ref_eval), (got_train, ref_train)):
        for k in ('rcnn_cls', 'rcnn_reg'):
            tp.assert_close(got[k], ref[k], err_msg=k)
    stats = jax_tree_to_port(head, state['batch_stats'], 'batch_stats')
    buffers = dict(head.named_buffers())
    assert any('roi_grid_vpool.group_1.separate_bn' in k for k in stats)
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.fixture(scope='module')
def predicts(cfg):
    with tp.pinned_f32():
        return tp.run_predicts(cfg)


def test_keypoints_and_proposals(cfg, predicts):
    from glenet_tpu_torch.models import vector_pool
    jax_full, _, full, _, _ = predicts
    ref, got = jax_full['proposals'], full['proposals']
    for k in ('roi_labels', 'roi_valid'):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    assert got['roi_valid'].sum() > 8
    tp.assert_close(got['rois'], ref['rois'])
    tp.assert_close(got['roi_scores'], ref['roi_scores'])
    np.testing.assert_array_equal(full['pfe']['keypoints'].numpy(),
                                  jax_full['pfe']['keypoints'])
    tp.assert_close(full['pfe']['point_cls_preds'],
                    jax_full['pfe']['point_cls_preds'])
    # SPC: every keypoint within SAMPLE_RADIUS_WITH_ROI of a proposal
    kp = full['pfe']['keypoints']
    near = vector_pool.sample_points_with_roi_mask(
        kp, torch.ones(kp.shape[:2], dtype=torch.bool), got['rois'],
        got['roi_valid'],
        cfg.MODEL.PFE.SPC_SAMPLING.SAMPLE_RADIUS_WITH_ROI)
    assert near.all()


def test_rcnn_outputs_and_predict(predicts):
    jax_full, jax_pred, full, pred, _ = predicts
    for k in ('rcnn_cls', 'rcnn_reg'):
        tp.assert_close(full['rcnn'][k], jax_full['rcnn'][k], err_msg=k)
    tp.assert_predict_equal(pred, jax_pred)
    for k in ('final_boxes', 'final_scores'):
        tp.assert_close(pred[k], jax_pred[k], err_msg=k)


@pytest.fixture(scope='module')
def step(cfg):
    with tp.pinned_f32():
        return tp.run_train_steps(cfg, dropout=True, gt_offset=GT_OFFSET)


def test_loss_terms(step):
    ref, metrics, _, _ = step
    assert ref['targets']['reg_valid_mask'].sum() > 0
    assert {'loss_cls', 'loss_loc', 'point_loss_cls', 'rcnn_loss_cls',
            'rcnn_loss_reg', 'rcnn_loss_corner'} <= set(metrics)
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_gradients(step):
    ref, _, grads, tdet = step
    for k in ('pfe.vp_raw_points.group_0.separate_w',
              'pfe.vp_x_conv3.group_1.separate_w',
              'pfe.vp_x_conv4.msg_0.weight', 'pfe.fusion.weight',
              'point_head_simple.cls_out.weight',
              'roi_head.roi_grid_vpool.group_1.separate_w',
              'backbone_3d.conv_input.kernel', 'dense_head.hm_1.weight'):
        assert float(grads[k].abs().max()) > 0, k
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_bn_stats(step):
    ref, _, _, tdet = step
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


def test_params_after_adam(cfg, step):
    ref, _, grads, tdet = step
    tp.assert_params_after_adam(
        tdet, ref, grads, cfg.OPTIMIZATION.LR / cfg.OPTIMIZATION.DIV_FACTOR)


def test_msgpack_reader(cfg, predicts, tmp_path):
    """The predict fixture's variables saved by glenet_tpu.train.checkpoint
    load through the port's .msgpack reader and predict as glenet_tpu did
    on them."""
    from glenet_tpu.train import checkpoint as ckpt_lib
    from glenet_tpu.train import optim, state as state_lib

    from glenet_tpu_torch.train import jax_checkpoint
    from __graft_entry__ import _make_batch
    _, jax_pred, _, _, variables = predicts
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    params = jax.tree.map(jnp.asarray, variables['params'])
    ts = state_lib.TrainState(
        step=jnp.asarray(5, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables['batch_stats']),
        opt_state=tx.init(params))
    path = ckpt_lib.save_checkpoint(ckpt_lib.checkpoint_state(ts, 1, 5),
                                    tmp_path / 'ckpt', 1)
    tdet = jax_checkpoint.build_detector_from_checkpoint(
        tp.to_port_cfg(cfg), path, device='cpu')
    batch = _make_batch(2, n_points=1024, seed=3,
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    with tp.pinned_f32(), torch.no_grad():
        pred = tdet.predict({k: torch.from_numpy(np.array(batch[k]))
                             for k in ('points', 'points_mask')})
    tp.assert_predict_equal(pred, jax_pred)


def test_resnet_predict():
    """pv_rcnn_plusplus_resnet.yaml's toy (VoxelResBackBone8x)."""
    cfg = tp.tiny_pvpp_cfg(resnet=True)
    with tp.pinned_f32():
        jax_full, jax_pred, full, pred, _ = tp.run_predicts(cfg)
    assert full['backbone_3d']['multi_scale']['x_conv4']['features'].shape[
        -1] == 128
    np.testing.assert_array_equal(full['pfe']['keypoints'].numpy(),
                                  jax_full['pfe']['keypoints'])
    for k in ('rcnn_cls', 'rcnn_reg'):
        tp.assert_close(full['rcnn'][k], jax_full['rcnn'][k], err_msg=k)
    tp.assert_predict_equal(pred, jax_pred)


@pytest.mark.parametrize('section,options', [
    ('PFE', {'SAMPLE_METHOD': 'SPC',
             'SPC_SAMPLING': {'SAMPLE_RADIUS_WITH_ROI': 1.6}}),
    ('PFE.SA_LAYER.raw_points', {'FILTER_NEIGHBOR_WITH_ROI': True,
                                 'RADIUS_OF_NEIGHBOR_WITH_ROI': 2.4})])
def test_pvrcnn_keypoint_options_need_rois(section, options):
    """Plain PV-RCNN samples its keypoints before the proposals, so the
    options that need the rois are a configuration error there (glenet_tpu
    asserts on them at the first call)."""
    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = tp.to_port_cfg(tp.tiny_pvrcnn_cfg())
    node = cfg.MODEL
    for part in section.split('.'):
        node = node[part]
    node.update(Cfg(options))
    with pytest.raises(ValueError, match='PVRCNNPlusPlus'):
        build_detector(cfg, device='cpu')


# ---------------------------------------------------------------------------
# the CLIs on a synthetic Waymo-layout tree
# ---------------------------------------------------------------------------

from test_torch_waymo_glenet_s import tree  # noqa: E402,F401


def _write_cli_cfg(path, root):
    """pv_rcnn_plusplus.yaml over the tree at `root` with the toy's model
    (tiny_pvpp_cfg's PFE, point head, RoI head and NMS, a 2D backbone of
    2 + 2 layers of 32 / 64) at +-9.6 m, 512 voxels and B = 2."""
    import yaml
    from test_torch_centerpoint import _write_cli_cfg as centerpoint_cli
    cfg = yaml.safe_load(centerpoint_cli(path, root).read_text())
    with open(ROOT / 'configs/waymo_models/pv_rcnn_plusplus.yaml') as f:
        pvpp = yaml.safe_load(f)
    toy = json.loads(json.dumps(tp.tiny_pvpp_cfg()))['MODEL']
    pvpp['MODEL'].update(PFE=toy['PFE'], POINT_HEAD=toy['POINT_HEAD'],
                         ROI_HEAD=toy['ROI_HEAD'],
                         BACKBONE_2D=cfg['MODEL']['BACKBONE_2D'],
                         POST_PROCESSING=cfg['MODEL']['POST_PROCESSING'])
    pvpp['MODEL']['PFE']['SA_LAYER']['raw_points'][
        'NUM_REDUCED_CHANNELS'] = 2
    pvpp['DATA_CONFIG'] = cfg['DATA_CONFIG']
    pvpp['OPTIMIZATION']['BATCH_SIZE_PER_GPU'] = 2
    path.write_text(yaml.safe_dump(pvpp))
    return path


def test_train_and_test_clis(tree, tmp_path):  # noqa: F811
    """`tools.train` (1 epoch x 2 steps at B = 2) and `tools.test` on the
    toy PV-RCNN++ over the synthetic Waymo tree: finite loss terms
    (the keypoint segmentation and RCNN ones included), then the Waymo AP
    / APH keys of the three classes."""
    import math

    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train
    root, _ = tree
    cfg_path = _write_cli_cfg(tmp_path / 'toy_pvpp.yaml', root)
    out = tmp_path / 'out'
    argv = ['--cfg_file', str(cfg_path), '--output_dir', str(out),
            '--device', 'cpu']
    run = train.main(argv + ['--epochs', '1', '--max_steps_per_epoch', '2'])
    assert [r['it'] for r in run['steps']] == [1, 2]
    for r in run['steps']:
        assert all(math.isfinite(r[k]) for k in (
            'loss', 'loss_cls', 'loss_loc', 'point_loss_cls',
            'rcnn_loss_cls', 'grad_norm'))
    (path, res), = test_cli.main(argv).items()
    assert path.endswith('checkpoint_epoch_0.pth') and res['frames'] == 2
    assert 'OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/APH' in res['ap']
    assert all(math.isfinite(v) for v in res['ap'].values())


def test_demo_on_waymo_frames(tree, tmp_path):  # noqa: F811
    """`tools.demo --ext .npy` runs the toy PV-RCNN++ over a sequence of the
    synthetic Waymo tree: one record per frame, labels among the three
    class names."""
    from glenet_tpu_torch.tools import demo
    from glenet_tpu_torch.utils import synthetic
    root, _ = tree
    cfg_path = _write_cli_cfg(tmp_path / 'toy_pvpp.yaml', root)
    seq = sorted((root / synthetic.WAYMO_PROCESSED).iterdir())[0]
    records = demo.main(['--cfg_file', str(cfg_path), '--data_path',
                         str(seq), '--ext', '.npy', '--device', 'cpu',
                         '--output', str(tmp_path / 'dets.jsonl')])
    assert len(records) == len(list(seq.glob('*.npy'))) > 0
    assert {n for r in records for n in r['labels']} <= {
        'Vehicle', 'Pedestrian', 'Cyclist'}
    assert sum(len(r['scores']) for r in records) > 0
