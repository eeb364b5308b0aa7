"""Parity of the port's PV-RCNN (MODEL.NAME PVRCNN: VoxelBackBone8x with
x_conv4's site list, VoxelSetAbstraction, PointHeadSimple, PVRCNNHead) with
glenet_tpu on its toy version (torch_parity.tiny_pvrcnn_cfg: 64 keypoints
from all six sources, a 4^3 RoI grid), on the CPU, same numpy-drawn
weights and points (with intensities), f32 on both sides:

  - configs/kitti_models/pv_rcnn.yaml and configs/waymo_models/
    pv_rcnn.yaml build at full width;
  - a predict: keypoints, proposals, final labels and valid flags exactly;
    keypoint logits, RCNN outputs and rois rtol 1e-4 / atol 1e-5, final
    boxes and scores also atol 1e-4;
  - one train step with JAX's RoI draws fed to the port and DP_RATIO 0:
    every loss term (point_loss_cls included) rtol 1e-4, every gradient
    per tensor max |diff| <= 2e-4 max |grad| + 1e-6, BN running stats
    rtol 1e-4 / atol 1e-5;
  - x_conv4's active-site list equals glenet_tpu's strided_output_sites,
    also when the level cap decimates it; other families' levels carry no
    x_conv4 list;
  - weights: glenet_tpu's variables round-trip through the bridge with no
    leaf left over; a synthetic reference PV-RCNN state dict gives equal
    stage-1 variables and the same unconsumed keys through both
    converters; a glenet_tpu .msgpack predicts through the port's reader
    as glenet_tpu does."""
import copy
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize('path,n_kp,sources', [
    ('kitti_models/pv_rcnn.yaml', 2048, 6),
    ('waymo_models/pv_rcnn.yaml', 4096, 4)])
def test_yaml_builds(path, n_kp, sources):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(cfg_from_yaml_file(str(ROOT / 'configs' / path)),
                         device='cpu')
    net = det.net
    assert net.pfe.num_keypoints == n_kp and len(net.pfe.sources) == sources
    assert net.backbone_3d.site_lists
    # the fused keypoint features (128) over the 6^3 grid, two radii of 64
    assert net.roi_head.shared_0.weight.shape == (256, 128 * 216)
    assert net.roi_head.shared_bn0.eps == 1e-5
    assert net.point_head_simple.cls_out.weight.shape == (1, 256)
    assert net.point_head_simple.cls_bn0.eps == 1e-3
    raw = net.pfe.sa_raw_points.mlp_r0.mlp_0.weight.shape[1]
    assert raw == 3 + det.num_point_features - 3


@pytest.fixture(scope='module')
def cfg():
    return tp.tiny_pvrcnn_cfg()


@pytest.fixture(scope='module')
def points():
    """Uniform points in the toy range with intensities in [0, 1)."""
    rng = np.random.RandomState(21)
    pts = np.zeros((2, 1024, 4), np.float32)
    pts[..., 0] = rng.uniform(0, 16, (2, 1024))
    pts[..., 1] = rng.uniform(-8, 8, (2, 1024))
    pts[..., 2] = rng.uniform(-1.1, 1.1, (2, 1024))
    pts[..., 3] = rng.uniform(0, 1, (2, 1024))
    return pts


@pytest.fixture(scope='module')
def predicts(cfg, points):
    with tp.pinned_f32():
        return tp.run_predicts(cfg, points=points)


@pytest.fixture(scope='module')
def step(cfg, points):
    cfg = copy.deepcopy(cfg)
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    with tp.pinned_f32():
        return tp.run_train_steps(cfg, points=points)


def test_keypoints_and_proposals(predicts, points):
    jax_full, _, full, _, _ = predicts
    np.testing.assert_array_equal(full['pfe']['keypoints'].numpy(),
                                  jax_full['pfe']['keypoints'])
    idx = full['pfe']['keypoint_idx'].numpy()
    np.testing.assert_array_equal(
        points[np.arange(2)[:, None], idx, :3], jax_full['pfe']['keypoints'])
    tp.assert_close(full['pfe']['point_cls_preds'],
                    jax_full['pfe']['point_cls_preds'])
    ref, got = jax_full['proposals'], full['proposals']
    for k in ('roi_labels', 'roi_valid'):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    tp.assert_close(got['rois'], ref['rois'])
    tp.assert_close(got['roi_scores'], ref['roi_scores'])


def test_rcnn_outputs(predicts):
    jax_full, _, full, _, _ = predicts
    for k in ('rcnn_cls', 'rcnn_reg'):
        tp.assert_close(full['rcnn'][k], jax_full['rcnn'][k], err_msg=k)
    assert 'rcnn_reg_std' not in full['rcnn']


def test_predict(predicts):
    _, jax_pred, _, pred, _ = predicts
    tp.assert_predict_equal(pred, jax_pred)
    for k in ('final_boxes', 'final_scores'):
        tp.assert_close(pred[k], jax_pred[k], err_msg=k)


def test_loss_terms(step):
    ref, metrics, _, _ = step
    assert ref['targets']['reg_valid_mask'].sum() > 0
    assert float(ref['metrics']['point_loss_cls']) > 0
    assert {'point_loss_cls', 'rcnn_loss_cls', 'rcnn_loss_reg'} <= set(
        metrics)
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_gradients(step):
    ref, _, grads, tdet = step
    for k in ('pfe.fusion.weight', 'point_head_simple.cls_out.weight',
              'pfe.sa_x_conv1.mlp_r0.mlp_0.weight',
              'roi_head.roi_grid_pool.mlp_r0.mlp_0.weight',
              'backbone_3d.conv_input.kernel'):
        assert float(grads[k].abs().max()) > 0, k
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_bn_stats(step):
    ref, _, _, tdet = step
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


@pytest.mark.parametrize('decimate', [False, True])
def test_x_conv4_site_list(cfg, points, decimate, monkeypatch):
    """The list of x_conv4 equals glenet_tpu's strided_output_sites of
    x_conv3's sites at caps[3]; undecimated its sites are the dense
    level's occupied cells."""
    from glenet_tpu.ops import sparse as jsp

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.ops import sparse as tsp
    if decimate:
        monkeypatch.setattr(tsp, 'LEVEL_CAP_MULTIPLIERS',
                            (1.0, 3.3, 3.8, 0.02))
    det = build_detector(tp.to_port_cfg(cfg), device='cpu')
    with torch.no_grad():
        vox = det.net.voxelize(torch.from_numpy(points),
                               torch.ones(points.shape[:2], dtype=bool),
                               det.max_voxels_test)
        sp = det.net.backbone_3d(
            det.net.vfe(vox['voxels'], vox['voxel_num_points']),
            vox['voxel_coords'], vox['voxel_mask'])
    l3, l4 = sp['multi_scale']['x_conv3'], sp['multi_scale']['x_conv4']
    cap = tsp.level_caps(det.max_voxels_test)[3]
    ref_ids, ref_mask = jax.vmap(lambda i, m: jsp.strided_output_sites(
        i, m, l3['grid'], 3, 2, (0, 1, 1), cap))(
        jnp.asarray(l3['ids'].numpy()), jnp.asarray(l3['mask'].numpy()))
    np.testing.assert_array_equal(l4['ids'].numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(l4['mask'].numpy(), np.asarray(ref_mask))
    n_occ = l4['occ'].flatten(1).sum(1)
    if decimate:
        assert (n_occ > cap).all() and l4['mask'].all()
    else:
        assert (l4['mask'].sum(1) == n_occ).all()
        occ = l4['occ'].flatten(1)
        for b in range(2):
            assert occ[b, l4['ids'][b][l4['mask'][b]].long()].all()


def test_other_families_keep_their_levels():
    """A model without a PFE builds no x_conv4 site list."""
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(tp.to_port_cfg(tp.tiny_single_stage_cfg('IOU')),
                         device='cpu')
    assert not det.net.backbone_3d.site_lists and det.net.pfe is None
    pts = torch.zeros((1, 64, 4))
    pts[..., 0] = torch.linspace(1, 15, 64)
    with torch.no_grad():
        out = det.net(pts, torch.ones((1, 64), dtype=torch.bool))
    assert set(out['backbone_3d']['multi_scale']['x_conv4']) == {
        'kind', 'features', 'occ', 'grid', 'stride'}


def test_variables_round_trip(cfg, predicts):
    """glenet_tpu's toy PV-RCNN variables -> the port -> a glenet_tpu tree
    with the same leaves and values."""
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import (load_jax_variables,
                                                    port_to_jax_variables)
    variables = predicts[4]
    det = build_detector(tp.to_port_cfg(cfg), device='cpu')
    load_jax_variables(det.net, variables)
    back = port_to_jax_variables(det.net)
    ref = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(ref)
    assert any('sa_x_conv4' in str(k) for k in ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))


def test_converters_agree_full_width():
    """pv_rcnn.yaml: both converters fill the stage-1 subtrees equally and
    leave every pfe.*, point_head.* and roi_head.* key unconsumed."""
    from glenet_tpu.config import cfg_from_yaml_file
    from glenet_tpu.utils import weight_converter as jwc
    from test_torch_weight_converter import _assert_trees_equal

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils import synthetic
    from glenet_tpu_torch.utils import weight_converter as wc
    from glenet_tpu_torch.utils.jax_weights import (load_jax_variables,
                                                    port_to_jax_variables)
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/pv_rcnn.yaml'))
    tcfg = tp.to_port_cfg(cfg)
    det = build_detector(tcfg, device='cpu')
    template = port_to_jax_variables(det.net)
    sd = {k: v.numpy() for k, v in
          synthetic.pcdet_state_dict(tcfg, seed=1).items()}
    ref, ref_report = jwc.convert_full_model(cfg, sd, template)
    got, report = wc.convert_full_model(tcfg, sd, template)
    _assert_trees_equal(got, ref)
    assert report == ref_report
    assert report['converted'] == ['backbone_3d', 'backbone_2d',
                                   'dense_head']
    assert report['unconsumed'] == sorted(
        k for k in sd if k.startswith(('pfe.', 'point_head.', 'roi_head.'))
        and 'num_batches_tracked' not in k)
    assert any(k.startswith('pfe.SA_layers.3.') for k in sd)
    load_jax_variables(det.net, got)


def test_msgpack_reader(cfg, predicts, points, tmp_path):
    """The predict fixture's variables saved by glenet_tpu.train.checkpoint
    load through the port's .msgpack reader and predict as glenet_tpu
    did on them."""
    from glenet_tpu.train import checkpoint as ckpt_lib
    from glenet_tpu.train import optim, state as state_lib

    from glenet_tpu_torch.train import jax_checkpoint
    _, jax_pred, _, _, variables = predicts
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    params = jax.tree.map(jnp.asarray, variables['params'])
    ts = state_lib.TrainState(
        step=jnp.asarray(12, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables['batch_stats']),
        opt_state=tx.init(params))
    path = ckpt_lib.save_checkpoint(ckpt_lib.checkpoint_state(ts, 3, 12),
                                    tmp_path / 'ckpt', 3)
    tdet = jax_checkpoint.build_detector_from_checkpoint(
        tp.to_port_cfg(cfg), path, device='cpu')
    with tp.pinned_f32(), torch.no_grad():
        pred = tdet.predict({'points': torch.from_numpy(points),
                             'points_mask': torch.ones(points.shape[:2],
                                                       dtype=torch.bool)})
    tp.assert_predict_equal(pred, jax_pred)


def _reg_loss_case(overflow):
    """4 rois (2 foreground, 2 background) with gt boxes 0.2 m off; with
    `overflow` the last background roi has sizes ~1e20, as a diverging
    dense head proposes after a step at the one-cycle's peak rate."""
    rng = np.random.RandomState(12)
    rois = np.zeros((1, 4, 7), np.float32)
    rois[0, :, :3] = rng.uniform(-10, 10, (4, 3))
    rois[0, :, 3:6] = rng.uniform(1, 4, (4, 3))
    rois[0, :, 6] = rng.uniform(-3, 3, 4)
    gt = np.concatenate([rois + 0.2, np.ones((1, 4, 1), np.float32)], -1)
    if overflow:
        rois[0, 3, 3:6] = [1.7e20, 1.0e18, 4.2e19]
    reg = rng.randn(4, 7).astype(np.float32) * 0.3
    return rois, gt, reg, np.array([[1, 1, 0, 0]], np.int32)


def test_rcnn_reg_loss_ignores_an_overflowing_background_roi():
    """Background rois add exactly 0 to the RCNN regression and corner
    losses and to their gradients, as in the reference's fg-only losses:
    with a roi whose corners overflow, the port's loss and gradients stay
    those of the finite case (glenet_tpu's mask-multiply gives NaN
    gradients there, and the port's did NaN in the forward); both packages'
    losses agree."""
    from glenet_tpu.models import roi_heads as jroi
    from glenet_tpu.utils import box_coder as jbc

    from glenet_tpu_torch.models import roi_heads
    from glenet_tpu_torch.utils import box_coder
    lw = {'rcnn_reg_weight': 1.0}
    got = {}
    for overflow in (False, True):
        rois, gt, reg, fg = _reg_loss_case(overflow)
        t_rois, t_gt = torch.from_numpy(rois), torch.from_numpy(gt)
        t_reg = torch.from_numpy(reg).requires_grad_()
        ct = roi_heads.canonical_gt_of_rois(t_rois[0], t_gt[0])[None]
        loss, parts = roi_heads.rcnn_reg_loss(
            t_reg, None, t_rois, ct, t_gt, torch.ones((1, 4, 7)),
            torch.from_numpy(fg), box_coder.build_box_coder('ResidualCoder'),
            lw)
        loss.backward()
        assert bool(torch.isfinite(t_reg.grad).all())
        assert not t_reg.grad[2:].any()
        got[overflow] = (float(loss), float(parts['rcnn_loss_corner']),
                         t_reg.grad.numpy())
        j_ct = jroi.canonical_gt_of_rois(jnp.asarray(rois[0]),
                                         jnp.asarray(gt[0]))[None]

        def jax_loss(r, j_ct=j_ct, rois=rois, gt=gt, fg=fg):
            return jroi.rcnn_reg_loss(
                r, None, jnp.asarray(rois), j_ct, jnp.asarray(gt),
                jnp.ones((1, 4, 7)), jnp.asarray(fg),
                jbc.build_box_coder('ResidualCoder'), lw, kl_label=False)

        ref, ref_parts = jax_loss(jnp.asarray(reg))
        np.testing.assert_allclose(got[overflow][0], float(ref), rtol=1e-5)
        np.testing.assert_allclose(got[overflow][1],
                                   float(ref_parts['rcnn_loss_corner']),
                                   rtol=1e-5)
        ref_grad = np.asarray(jax.grad(lambda r: jax_loss(r)[0])(
            jnp.asarray(reg)))
        assert np.isfinite(ref_grad).all() != overflow
        if not overflow:
            np.testing.assert_allclose(got[False][2], ref_grad, rtol=1e-5,
                                       atol=1e-7)
    assert got[True][:2] == got[False][:2]
    np.testing.assert_array_equal(got[True][2], got[False][2])
