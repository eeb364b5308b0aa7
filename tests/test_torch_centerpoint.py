"""Parity of the port's CenterPoint (MODEL.NAME CenterPoint: MeanVFE ->
VoxelResBackBone8x -> HeightCompression -> BaseBEVBackbone -> CenterHead ->
top-k decode -> nms_gpu) and of the CenterHead RPN of VoxelRCNN (dynamic
voxels, DynMeanVFE) and PVRCNN with glenet_tpu, on the CPU, same
numpy-drawn weights and points, f32 on both sides:

  - the six Waymo configs that use these pieces build at full width;
  - toy CenterPoint (toy_cfg: configs/waymo_models/centerpoint.yaml cut to
    +-9.6 m, 512 voxels, NMS 256 / 64 and a 2D backbone of 2 + 2 layers of
    32 / 64): voxels and every backbone level (integers exactly, features
    rtol 1e-4 / atol 1e-5), a predict at the published thresholds and at
    zero thresholds (final labels and valid flags exactly, boxes and
    scores rtol 1e-4 / atol 1e-4);
  - one train step: the CenterHead targets (cell indices and masks
    exactly, the heatmap's peaks exactly and its values within 2 ulp as
    test_torch_center_head.py says why, target boxes atol 1e-6), every loss
    term rtol 1e-4, every gradient per tensor max |diff| <= 2e-4 max |grad|
    + 1e-6 with the port taking JAX's side of the ReLU kinks within
    rounding of 0 (as test_torch_waymo_glenet_s.py), at the BN outputs and
    at the residual sums h + x of VoxelResBackBone8x, but the six CenterHead
    biases before a BN, whose exact gradient is 0, held to 1e-4 of their
    kernel's largest |gradient| (assert_center_grads), BN running stats rtol
    1e-4 / atol 1e-5, and the parameters after adam_onecycle as
    torch_parity.assert_params_after_adam;
  - VoxelRCNN with a CenterHead RPN on dynamic voxels and PVRCNN with a
    CenterHead RPN (the toy two-stage configs of torch_parity with the
    CenterHead of toy_cfg): a predict (proposals, final labels and valid
    flags exactly; RCNN outputs and final boxes / scores rtol 1e-4 / atol
    1e-4) and a train step with JAX's RoI sampling and dropout draws fed to
    the port (loss terms, gradients, BN stats as above)."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ('centerpoint.yaml', 'centerpoint_without_resnet.yaml',
           'centerpoint_pillar_1x.yaml', 'centerpoint_dyn_pillar_1x.yaml',
           'voxel_rcnn_with_centerhead_dyn_voxel.yaml',
           'pv_rcnn_with_centerhead_rpn.yaml')


@pytest.mark.parametrize('name', CONFIGS)
def test_yaml_builds(name):
    """Each config builds at full width on the CPU: its VFE, backbone and
    CenterHead (no anchors), the grid of its voxels or pillars."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(cfg_from_yaml_file(
        str(ROOT / 'configs/waymo_models' / name)), device='cpu')
    net = det.net
    assert det.is_center_head and det.anchor_set is None
    assert not hasattr(net, 'flat_anchors')
    assert type(net.dense_head).__name__ == 'CenterHead'
    assert net.dense_head.hm_1.weight.shape[0] == 3
    pillars = 'pillar' in name
    assert tuple(det.grid_size) == ((468, 468, 1) if pillars
                                    else (1504, 1504, 40))
    vfe = type(net.vfe).__name__
    assert vfe == {'centerpoint_pillar_1x.yaml': 'PillarVFE',
                   'centerpoint_dyn_pillar_1x.yaml': 'DynamicPillarVFE',
                   'voxel_rcnn_with_centerhead_dyn_voxel.yaml':
                   'DynamicMeanVFE'}.get(name, 'MeanVFE')
    if not pillars:
        res = name == 'centerpoint.yaml'
        assert net.backbone_3d.residual == res
        assert net.backbone_3d.num_bev_features == 256


def toy_cfg():
    """tests/test_waymo_models.py::tiny_waymo_cfg('centerpoint.yaml') cut
    to +-9.6 m (a 192 x 192 x 40 grid, a 24 x 24 BEV map), 512 voxels and
    a 2D backbone of 2 + 2 layers of 32 / 64 filters."""
    from glenet_tpu.config import Cfg
    from test_waymo_models import tiny_waymo_cfg
    cfg = tiny_waymo_cfg('centerpoint.yaml')
    cfg.MODEL.BACKBONE_2D = Cfg({
        'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [2, 2],
        'LAYER_STRIDES': [1, 2], 'NUM_FILTERS': [32, 64],
        'UPSAMPLE_STRIDES': [1, 2], 'NUM_UPSAMPLE_FILTERS': [32, 32]})
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [-9.6, -9.6, -2.0, 9.6, 9.6, 4.0]
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'transform_points_to_voxels':
            proc.MAX_NUMBER_OF_VOXELS = {'train': 512, 'test': 512}
    cfg.OPTIMIZATION.NUM_EPOCHS = 1
    return cfg


SIZES = {1: (4.6, 2.0, 1.7), 2: (0.8, 0.8, 1.8), 3: (1.8, 0.6, 1.7)}


def center_batch(batch_size=2, n_points=1024, n_gt=6, seed=3):
    """Toy Waymo batch: 5-feature points, a third of them on 3 gt boxes per
    sample (a Vehicle, a Pedestrian and a Cyclist at their sizes), the
    rest uniform over +-9.6 m; numpy arrays."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n_points, 5), np.float32)
    pts[..., :2] = rng.uniform(-9.6, 9.6, (batch_size, n_points, 2))
    pts[..., 2] = rng.uniform(-1.9, 3.9, (batch_size, n_points))
    pts[..., 3:] = rng.uniform(0, 1, (batch_size, n_points, 2))
    gt = np.zeros((batch_size, n_gt, 8), np.float32)
    gt_mask = np.zeros((batch_size, n_gt), bool)
    per = n_points // 9
    for b in range(batch_size):
        for g, cls in enumerate((1, 2, 3)):
            dx, dy, dz = SIZES[cls]
            gt[b, g] = [rng.uniform(-7, 7), rng.uniform(-7, 7), dz / 2 - 0.5,
                        dx, dy, dz, rng.uniform(-np.pi, np.pi), cls]
            gt_mask[b, g] = True
            local = rng.uniform(-0.5, 0.5, (per, 3)) * [dx, dy, dz]
            c, s = np.cos(gt[b, g, 6]), np.sin(gt[b, g, 6])
            sl = slice(g * per, (g + 1) * per)
            pts[b, sl, 0] = gt[b, g, 0] + local[:, 0] * c - local[:, 1] * s
            pts[b, sl, 1] = gt[b, g, 1] + local[:, 0] * s + local[:, 1] * c
            pts[b, sl, 2] = gt[b, g, 2] + local[:, 2]
    unc = rng.uniform(0.02, 0.3, (batch_size, n_gt, 7)).astype(np.float32)
    return {'points': pts, 'points_mask': np.ones(pts.shape[:2], bool),
            'gt_boxes': gt, 'gt_mask': gt_mask, 'gt_uncertainty': unc}


@pytest.fixture(scope='module')
def runs():
    cfg = toy_cfg()
    batch = center_batch()
    with tp.pinned_f32():
        predicts = tp.run_single_stage_predicts(cfg, batch)
        step = tp.run_single_stage_step(cfg, batch, align_relu=True)
    return cfg, batch, predicts, step


def test_stages(runs):
    tp.assert_single_stage_stages(runs[2])
    full = runs[2][1]['full']
    assert full['dense_head']['hm'].shape == (2, 24, 24, 3)
    assert int(full['vox']['voxel_mask'].sum(1).min()) == 512


def test_predict(runs):
    ref = runs[2][0]['pred']
    assert ref['final_valid'].sum() > 10
    tp.assert_single_stage_predict(runs[2], 'pred')


def test_predict_zero_thresholds(runs):
    ref = runs[2][0]['pred_zero']
    assert ref['final_valid'].sum(1).min() > 10
    tp.assert_single_stage_predict(runs[2], 'pred_zero')


def test_targets(runs):
    ref, _, _, targets, _ = runs[3]
    ref = ref['targets']
    np.testing.assert_array_equal(targets['inds'], ref['inds'])
    np.testing.assert_array_equal(targets['mask'], ref['mask'])
    assert ref['mask'].sum() == 6
    hm, hm_r = targets['heatmap'], ref['heatmap']
    np.testing.assert_array_equal(hm == 1.0, hm_r == 1.0)
    assert (hm_r == 1.0).sum() >= 5 and (hm_r[:, 1] == 1.0).any()
    np.testing.assert_allclose(hm, hm_r, rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(targets['target_boxes'], ref['target_boxes'],
                               rtol=0, atol=1e-6)


def test_loss_terms(runs):
    ref, metrics, _, _, _ = runs[3]
    assert set(ref['metrics']) == {'loss', 'loss_cls', 'loss_loc',
                                   'grad_norm'}
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def assert_center_grads(grads, ref_grads, tdet):
    """torch_parity.assert_grads_equal, except for the CenterHead's biases
    before its BNs (USE_BIAS_BEFORE_NORM): a train-mode BN's batch mean
    takes them out, so their exact gradient is 0 and both packages return
    rounding noise there; each is held to 1e-4 of its conv kernel's
    largest |gradient| on both sides."""
    from glenet_tpu_torch.models.center_head import HEADS
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref = jax_tree_to_port(tdet.net, ref_grads)
    noise = {f'dense_head.{n}_0.bias' for n, _ in HEADS} | {
        'dense_head.Conv_0.bias'}
    assert noise <= set(ref) and set(ref) == set(grads)
    for k in noise:
        bound = 1e-4 * np.abs(ref[k.replace('bias', 'weight')]).max()
        assert np.abs(ref[k]).max() <= bound, k
        assert np.abs(grads[k].numpy()).max() <= bound, k
    tp.assert_grads_equal({k: v for k, v in grads.items() if k not in noise},
                          {k: v for k, v in ref.items() if k not in noise},
                          tdet, port_keys=True)


def test_gradients(runs):
    ref, _, grads, _, tdet = runs[3]
    assert ref['relu_flipped'] <= 8, ref['relu_flipped']
    assert ref['residual_flipped'] <= 4, ref['residual_flipped']
    assert_center_grads(grads, ref['grads'], tdet)


def test_bn_stats(runs):
    ref, _, _, _, tdet = runs[3]
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


def test_params_after_adam(runs):
    cfg, _, _, step = runs
    ref, _, grads, _, tdet = step
    tp.assert_params_after_adam(
        tdet, ref, grads, cfg.OPTIMIZATION.LR / cfg.OPTIMIZATION.DIV_FACTOR)


def _center_rpn(cfg):
    """toy_cfg's CenterHead (16 shared channels) as the RPN of a toy
    two-stage config, with its proposal decode settings."""
    from glenet_tpu.config import Cfg
    head = toy_cfg().MODEL.DENSE_HEAD
    head.SHARED_CONV_CHANNEL = 16
    head.POST_PROCESSING = Cfg({'SCORE_THRESH': 0.0,
                                'MAX_OBJ_PER_SAMPLE': 500})
    cfg.CLASS_NAMES = ['Vehicle', 'Pedestrian', 'Cyclist']
    cfg.MODEL.DENSE_HEAD = head
    return cfg


def two_stage_cfg(kind):
    """'voxel_rcnn_dyn': the toy Voxel R-CNN (plain VoxelRCNNHead, DP_RATIO
    0.3) on dynamic voxels (DynMeanVFE, the placeholder processor) with the
    CenterHead RPN, as voxel_rcnn_with_centerhead_dyn_voxel.yaml; 'pv_rcnn':
    torch_parity's toy PV-RCNN (DP_RATIO 0.3) with it, as
    pv_rcnn_with_centerhead_rpn.yaml."""
    if kind == 'pv_rcnn':
        return _center_rpn(tp.tiny_pvrcnn_cfg())
    cfg = tp.plain_voxel_rcnn_cfg(_center_rpn(tp.tiny_twostage_cfg()))
    proc = cfg.DATA_CONFIG.DATA_PROCESSOR[0]
    proc.NAME = 'transform_points_to_voxels_placeholder'
    del proc['MAX_POINTS_PER_VOXEL']
    cfg.MODEL.VFE.NAME = 'DynMeanVFE'
    from glenet_tpu.config import Cfg
    cfg.OPTIMIZATION = Cfg(dict(tp.TINY_OPTIMIZATION))
    return cfg


# the gts' offset from the proposals they are made from (x, y, z, dx, dy,
# dz, heading): a CenterHead's proposal decodes its own regression at the
# proposal's cell, so a gt equal to it in any code puts the L1 loss on its
# kink, where rounding picks the gradient's sign
GT_OFFSET = (0.15, -0.1, 0.12, 0.2, -0.1, 0.15, 0.05)


@pytest.fixture(scope='module', params=['voxel_rcnn_dyn', 'pv_rcnn'])
def two_stage(request):
    cfg = two_stage_cfg(request.param)
    with tp.pinned_f32():
        predicts = tp.run_predicts(cfg)
        step = tp.run_train_steps(cfg, dropout=True, gt_offset=GT_OFFSET)
    return request.param, predicts, step


def test_two_stage_predict(two_stage):
    kind, (jax_full, jax_pred, full, pred, _), _ = two_stage
    for k in ('roi_labels', 'roi_valid'):
        np.testing.assert_array_equal(full['proposals'][k].numpy(),
                                      jax_full['proposals'][k], err_msg=k)
    assert full['proposals']['roi_valid'].sum() > 4
    tp.assert_close(full['proposals']['rois'], jax_full['proposals']['rois'],
                    atol=1e-4)
    for k in ('rcnn_cls', 'rcnn_reg'):
        tp.assert_close(full['rcnn'][k], jax_full['rcnn'][k], atol=1e-4,
                        err_msg=k)
    tp.assert_predict_equal(pred, jax_pred)
    if kind == 'voxel_rcnn_dyn':
        assert 'voxels' not in full['vox']


def test_two_stage_loss_terms(two_stage):
    kind, _, (ref, metrics, _, _) = two_stage
    assert {'loss_cls', 'loss_loc', 'rcnn_loss_cls'} <= set(metrics)
    assert ('point_loss_cls' in metrics) == (kind == 'pv_rcnn')
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_two_stage_gradients(two_stage):
    _, _, (ref, _, grads, tdet) = two_stage
    assert_center_grads(grads, ref['grads'], tdet)


def test_two_stage_bn_stats(two_stage):
    _, _, (ref, _, _, tdet) = two_stage
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


def test_train_step_through_state(runs):
    """The port's train state steps CenterPoint from torch's seeded
    initialisation: a finite loss, and adam_onecycle moves every parameter
    except one that is zero with a zero gradient (an L1 box-loss bias
    whose gts' signs cancel; weight decay keeps it at zero)."""
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train import optim, state as st
    cfg, batch = tp.to_port_cfg(runs[0]), runs[1]
    torch.manual_seed(0)
    det = build_detector(cfg, device='cpu')
    before = {n: p.detach().clone() for n, p in det.net.named_parameters()}
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 10)
    state = st.create_train_state(det, tx)
    _, metrics = st.make_train_step(det, tx)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(metrics['loss']))
    stuck = [n for n, p in det.net.named_parameters()
             if torch.equal(p.detach(), before[n])
             and (bool(p.detach().any()) or bool(p.grad.any()))]
    assert not stuck, stuck


# ---------------------------------------------------------------------------
# the CLIs on a synthetic Waymo-layout tree
# ---------------------------------------------------------------------------

from test_torch_waymo_glenet_s import tree  # noqa: E402,F401


def _write_cli_cfg(path, root):
    """centerpoint.yaml with Waymo's data config over the tree at `root`
    (augmentations included, gt sampling of its Vehicles), toy_cfg's range,
    budget, 2D backbone and NMS, every train frame and B = 2."""
    import json

    import yaml
    with open(ROOT / 'configs/waymo_models/centerpoint.yaml') as f:
        cfg = yaml.safe_load(f)
    with open(ROOT / 'configs/dataset_configs/waymo_dataset.yaml') as f:
        data = yaml.safe_load(f)
    toy = json.loads(json.dumps(toy_cfg()))
    data.update(DATA_PATH=str(root),
                POINT_CLOUD_RANGE=toy['DATA_CONFIG']['POINT_CLOUD_RANGE'],
                SAMPLED_INTERVAL={'train': 1, 'test': 1},
                MAX_POINTS_PER_SCENE=4096, MAX_GT_PER_SCENE=32)
    data['DATA_PROCESSOR'][-1]['MAX_NUMBER_OF_VOXELS'] = {'train': 512,
                                                         'test': 512}
    data['DATA_AUGMENTOR']['AUG_CONFIG_LIST'][0]['SAMPLE_GROUPS'] = [
        'Vehicle:6']
    cfg['DATA_CONFIG'] = data
    cfg['MODEL']['BACKBONE_2D'] = toy['MODEL']['BACKBONE_2D']
    cfg['MODEL']['POST_PROCESSING'] = toy['MODEL']['POST_PROCESSING']
    cfg['MODEL']['POST_PROCESSING']['SCORE_THRESH'] = 0.0
    cfg['OPTIMIZATION']['BATCH_SIZE_PER_GPU'] = 2
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_train_and_test_clis(tree, tmp_path):  # noqa: F811
    """`tools.train` (1 epoch x 2 steps at B = 2) and `tools.test` on the
    toy CenterPoint over the synthetic Waymo tree: finite CenterPoint loss
    terms, then the Waymo AP / APH keys of the three classes."""
    import math

    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train
    root, _ = tree
    cfg_path = _write_cli_cfg(tmp_path / 'toy_centerpoint.yaml', root)
    out = tmp_path / 'out'
    argv = ['--cfg_file', str(cfg_path), '--output_dir', str(out),
            '--device', 'cpu']
    run = train.main(argv + ['--epochs', '1', '--max_steps_per_epoch', '2'])
    assert [r['it'] for r in run['steps']] == [1, 2]
    for r in run['steps']:
        assert all(math.isfinite(r[k]) for k in (
            'loss', 'loss_cls', 'loss_loc', 'grad_norm'))
    (path, res), = test_cli.main(argv).items()
    assert path.endswith('checkpoint_epoch_0.pth') and res['frames'] == 2
    assert 'OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/APH' in res['ap']
    assert all(math.isfinite(v) for v in res['ap'].values())


def test_demo_on_waymo_frames(tree, tmp_path):  # noqa: F811
    """`tools.demo --ext .npy` runs the toy CenterPoint (5 point features)
    over a sequence of the synthetic Waymo tree: one record per frame,
    labels among the three class names."""
    from glenet_tpu_torch.tools import demo
    from glenet_tpu_torch.utils import synthetic
    root, _ = tree
    cfg_path = _write_cli_cfg(tmp_path / 'toy_centerpoint.yaml', root)
    seq = sorted((root / synthetic.WAYMO_PROCESSED).iterdir())[0]
    records = demo.main(['--cfg_file', str(cfg_path), '--data_path',
                         str(seq), '--ext', '.npy', '--device', 'cpu',
                         '--output', str(tmp_path / 'dets.jsonl')])
    assert len(records) == len(list(seq.glob('*.npy'))) > 0
    names = {n for r in records for n in r['labels']}
    assert names <= {'Vehicle', 'Pedestrian', 'Cyclist'}
    assert sum(len(r['scores']) for r in records) > 0
