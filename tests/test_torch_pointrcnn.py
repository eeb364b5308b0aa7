"""Parity of the port's PointRCNN (MODEL.NAME PointRCNN with PointNet2MSG:
PointHeadBox, and with ROI_HEAD PointRCNNHead the proposal NMS over the
point boxes, RoI point pooling and the refinement head) with glenet_tpu on
the toy configs of tests/test_pointrcnn.py (TINY_POINTRCNN, stage 1 alone;
make_two_stage_cfg), on the CPU, same numpy-drawn weights and points (with
intensities), f32 on both sides:

  - configs/kitti_models/pointrcnn.yaml and pointrcnn_iou.yaml build at
    full width;
  - a predict of each topology: the point head's logits and box encodings,
    proposals (valid flags and labels exactly), the RCNN outputs rtol 1e-4
    / atol 1e-5; final labels and valid flags exactly, final boxes and
    scores atol 1e-4 (tests/torch_parity.py assert_predict_equal);
  - one two-stage train step with JAX's RoI draws and dropout draws
    (DP_RATIO 0.3) fed to the port: every loss term rtol 1e-4, BN running
    stats rtol 1e-4 / atol 1e-5, every gradient per tensor max |diff| <=
    2e-4 max |grad| + 1e-6 (tests/torch_parity.py assert_grads_equal);
  - weights: the variables round-trip through the bridge with no leaf left
    over; a glenet_tpu .msgpack predicts through the port's reader as
    glenet_tpu does;
  - the host side: KittiDataset items with sample_points (down- and
    up-sampling) and shuffle_points equal glenet_tpu's on the same tree
    and seed."""
import copy
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from test_pointrcnn import TINY_POINTRCNN, make_two_stage_cfg  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize('name', ['pointrcnn.yaml', 'pointrcnn_iou.yaml'])
def test_yaml_builds(name):
    """The published widths: PointNet2MSG's 4 SA levels (the last of 1024
    channels) and FP levels down to 128 per point, PointHeadBox of 3
    classes and 8 box codes, PointRCNNHead without BN in its xyz-up, merge
    and SA layers (512 pooled points, the last SA level grouping all)."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models' / name))
    det = build_detector(cfg, device='cpu')
    net = det.net
    assert det.point_based and net.point_based
    assert [getattr(net.backbone_3d, f'sa_{i}').npoint for i in range(4)] \
        == [4096, 1024, 256, 64]
    assert net.backbone_3d.sa_3.out_channels == 1024
    assert net.backbone_3d.num_point_features == 128
    assert net.backbone_3d.fp_0.SharedMLP_0.mlp_0.weight.shape == (128, 257)
    assert net.point_head.cls_out.weight.shape == (3, 256)
    assert net.point_head.box_out.weight.shape == (8, 256)
    head = net.roi_head
    assert head.xyz_up.mlp_0.bias is not None
    assert head.merge_down.weight.shape == (128, 256)
    assert head.sa_2.npoint is None and head.sa_2.out_channels == 512
    assert head.cls_out.weight.shape == (1, 256)
    assert head.reg_out.weight.shape == (7, 256)
    tcfg = cfg.MODEL.ROI_HEAD.TARGET_CONFIG
    assert int(tcfg.ROI_PER_IMAGE) == 128
    assert tcfg.CLS_SCORE_TYPE == ('cls' if name == 'pointrcnn.yaml'
                                   else 'roi_iou')
    assert int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU) == (
        2 if name == 'pointrcnn.yaml' else 3)


@pytest.mark.parametrize('key,value', [('USE_BN', True),
                                       ('CLASS_AGNOSTIC', False)])
def test_unported_head_options_raise(key, value):
    """PointRCNNHead's options that no published yaml sets (BN in its xyz-up,
    merge and SA layers; per-class RCNN scores) are refused by name."""
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = tp.to_port_cfg(make_two_stage_cfg())
    cfg.MODEL.ROI_HEAD[key] = value
    with pytest.raises(NotImplementedError, match=key):
        build_detector(cfg, device='cpu')


def _two_stage():
    from glenet_tpu.config import Cfg
    cfg = make_two_stage_cfg()
    cfg.OPTIMIZATION = Cfg(dict(tp.TINY_OPTIMIZATION))
    return cfg


@pytest.fixture(scope='module')
def points():
    """Points in the toy range (a third in car-sized clusters) with
    intensities."""
    rng = np.random.RandomState(31)
    n = 512
    pts = np.zeros((2, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0, 16, (2, n))
    pts[..., 1] = rng.uniform(-8, 8, (2, n))
    pts[..., 2] = rng.uniform(-1.1, 1.1, (2, n))
    k = n // 3
    centres = rng.uniform([3, -5, -0.5], [13, 5, 0.5], (2, 6, 3))
    pts[:, :k, :3] = (centres[:, rng.randint(0, 6, k)]
                      + rng.randn(2, k, 3) * [1.0, 0.5, 0.3])
    pts[..., 3] = rng.uniform(0, 1, (2, n))
    return pts


@pytest.fixture(scope='module')
def predicts(points):
    """run_predicts of both topologies: {'stage1': ..., 'two_stage': ...}."""
    with tp.pinned_f32():
        return {'stage1': tp.run_predicts(TINY_POINTRCNN, points=points),
                'two_stage': tp.run_predicts(_two_stage(), points=points)}


@pytest.fixture(scope='module')
def step(points):
    cfg = _two_stage()
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.3
    with tp.pinned_f32():
        return tp.run_train_steps(cfg, points=points, dropout=True)


@pytest.mark.parametrize('kind', ['stage1', 'two_stage'])
def test_predict(predicts, kind):
    jax_full, jax_pred, full, pred, _ = predicts[kind]
    for k in ('point_cls_preds', 'point_box_preds'):
        tp.assert_close(full['point_head'][k], jax_full['point_head'][k],
                        err_msg=k)
    assert ('rcnn' in full) == ('rcnn' in jax_full) == (kind == 'two_stage')
    if kind == 'two_stage':
        prop, jprop = full['proposals'], jax_full['proposals']
        for k in ('roi_valid', 'roi_labels'):
            np.testing.assert_array_equal(prop[k].numpy(), jprop[k],
                                          err_msg=k)
        assert jprop['roi_valid'].sum() > 8
        for k in ('rois', 'roi_scores'):
            tp.assert_close(prop[k], jprop[k], err_msg=k)
        for k in ('rcnn_cls', 'rcnn_reg'):
            tp.assert_close(full['rcnn'][k], jax_full['rcnn'][k], err_msg=k)
    tp.assert_predict_equal(pred, jax_pred)


def test_loss_terms(step):
    ref, metrics, _, _ = step
    t = ref['targets']
    assert t['reg_valid_mask'].sum() > 0
    assert {-1.0, 0.0, 1.0} <= set(t['rcnn_cls_labels'].ravel().tolist())
    assert {'loss_cls', 'loss_loc', 'rcnn_loss_cls', 'rcnn_loss_reg',
            'rcnn_loss_corner'} <= set(metrics)
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_gradients(step):
    ref, _, grads, tdet = step
    for k in ('backbone_3d.sa_0.mlp_r0.mlp_0.weight',
              'backbone_3d.fp_0.SharedMLP_0.bn_0.bias',
              'point_head.box_out.weight', 'roi_head.xyz_up.mlp_0.weight',
              'roi_head.sa_1.mlp_1.weight', 'roi_head.reg_out.weight'):
        assert float(grads[k].abs().max()) > 0, k
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_bn_stats(step):
    ref, _, _, tdet = step
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


def test_variables_round_trip(predicts):
    """The two-stage toy variables -> the port -> a glenet_tpu tree with the
    same leaves and values."""
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import (load_jax_variables,
                                                    port_to_jax_variables)
    variables = predicts['two_stage'][4]
    det = build_detector(tp.to_port_cfg(_two_stage()), device='cpu')
    load_jax_variables(det.net, variables)
    back = port_to_jax_variables(det.net)
    ref = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(ref)
    for part in ('fp_3', 'mlp_r1', 'xyz_up', 'merge_down', 'cls_bn0'):
        assert any(part in str(k) for k in ref), part
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))


def test_msgpack_reader(predicts, points, tmp_path):
    """The two-stage predict's variables saved by glenet_tpu.train.
    checkpoint load through the port's .msgpack reader and predict as
    glenet_tpu did on them."""
    from glenet_tpu.train import checkpoint as ckpt_lib
    from glenet_tpu.train import optim, state as state_lib

    from glenet_tpu_torch.train import jax_checkpoint
    cfg = _two_stage()
    _, jax_pred, _, _, variables = predicts['two_stage']
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


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    """The mini-KITTI tree of tests/test_kitti_dataset.py prepared by each
    package."""
    import shutil

    from glenet_tpu.datasets.kitti_dataset import create_kitti_infos as j_cki
    from test_kitti_dataset import DATASET_CFG, make_kitti_tree

    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    base = tmp_path_factory.mktemp('pointrcnn_kitti')
    root = make_kitti_tree(base, np.random.RandomState(7))
    out = {'jax': root, 'port': base / 'kitti_port'}
    shutil.copytree(root, out['port'])
    j_cki(DATASET_CFG, ['Car'], out['jax'], out['jax'])
    create_kitti_infos(tp.to_port_cfg(DATASET_CFG), ['Car'], out['port'],
                       out['port'])
    return out


@pytest.mark.parametrize('training', [True, False])
@pytest.mark.parametrize('num_points', [512, 6000])
def test_sample_points_items(roots, training, num_points):
    """pointrcnn.yaml's DATA_PROCESSOR (range mask, sample_points,
    shuffle_points in training, voxels) on the mini tree: items of both
    packages equal for one seed, points down-sampled (512, the far points
    kept) or up-sampled (6000, repeats drawn)."""
    from glenet_tpu.datasets.kitti_dataset import KittiDataset as JDataset
    from test_kitti_dataset import DATASET_CFG

    from glenet_tpu_torch.datasets.kitti_dataset import KittiDataset
    cfg = copy.deepcopy(DATASET_CFG)
    cfg.MAX_POINTS_PER_SCENE = 6000
    procs = [p for p in cfg.DATA_PROCESSOR if p.NAME != 'shuffle_points']
    from glenet_tpu.config import Cfg
    procs.insert(1, Cfg({'NAME': 'sample_points', 'NUM_POINTS': {
        'train': num_points, 'test': num_points}}))
    procs.insert(2, Cfg({'NAME': 'shuffle_points', 'SHUFFLE_ENABLED': {
        'train': True, 'test': False}}))
    cfg.DATA_PROCESSOR = procs
    jds = JDataset(cfg, ['Car'], training=training, root_path=roots['jax'],
                   seed=4)
    tds = KittiDataset(tp.to_port_cfg(cfg), ['Car'], training=training,
                       root_path=roots['port'], seed=4)
    counts = []
    for i in range(len(jds)):
        ref, got = jds[i], tds[i]
        for k in ('points', 'points_mask', 'gt_boxes', 'gt_mask'):
            np.testing.assert_array_equal(ref[k], got[k], err_msg=(i, k))
        counts.append(int(ref['points_mask'].sum()))
    assert set(counts) == {num_points}


def test_convergence_harness_runs_pointrcnn(tmp_path, monkeypatch):
    """tools.convergence_ap takes a PointRCNN yaml: 2 steps of the toy
    two-stage config over 2 of the harness's scenes on the CPU, a finite
    loss and the KITTI AP keys in its entry."""
    import json
    import math
    import tempfile

    import yaml

    from glenet_tpu_torch.tools import convergence_ap as ca
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    monkeypatch.setattr(ca, 'N_SCENES', 2)
    path = tmp_path / 'pointrcnn.yaml'
    path.write_text(yaml.safe_dump(json.loads(json.dumps(_two_stage()))))
    out = tmp_path / 'results.json'
    entry = ca.main(['2', '1e-3', str(path), '--device', 'cpu', '--out',
                     str(out)])
    assert math.isfinite(entry['final_loss']) and entry['n_steps'] == 2
    assert entry['Car_3d_moderate_R40'] is not None
    assert list(json.loads(out.read_text())) == ['pointrcnn']
