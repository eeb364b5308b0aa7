"""Parity of the port's GLENet-S on Waymo (configs/waymo_models/
GLENet_S.yaml: 5 point features, one Vehicle class, variance voting over
NMS_PRE_MAXSIZE candidates) with glenet_tpu, on a toy version of it
(toy_cfg: tests/test_waymo_models.py::tiny_waymo_cfg, the published YAML
with NMS 256 / 64, cut further to +-9.6 m, 512 voxels and TINY_SECOND's 2D
backbone); then the port's train and test CLIs on a synthetic tree in
Waymo's processed layout, and its converter on a reference GLENet-S state
dict at Waymo's full widths.

Same numpy-drawn weights and points, f32 on both sides.  Tolerances:
integers exactly (voxels, levels, target labels, final labels and valid
flags); floats rtol 1e-4 / atol 1e-5, final boxes and scores also atol
1e-4; gradients per tensor max |diff| <= 2e-4 max |grad| + 1e-6, with
the port taking JAX's side of the ReLU kinks within rounding of 0
(test_gradients says why); parameters after adam_onecycle as
tests/test_torch_train_step.py; converted weights exactly.  The CLIs'
Waymo AP / APH equal glenet_tpu's evaluator on the same detections within
1e-3."""
import json
import logging
import pickle
from pathlib import Path

import numpy as np
import pytest
import yaml

jax = pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def toy_cfg():
    """tiny_waymo_cfg('GLENet_S.yaml') with TINY_SECOND's narrow 2D
    backbone (2 + 2 layers of 32 / 64 filters).  At the published widths
    (5 + 5 layers of 128 / 256) a BN over the 2 x 12 x 12 cells of the toy
    map's second branch sees so few values per channel that a ReLU input
    within f32 rounding of 0 moves its gradients by percents."""
    from glenet_tpu.config import Cfg
    from test_waymo_models import tiny_waymo_cfg
    cfg = tiny_waymo_cfg('GLENet_S.yaml')
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


def test_yaml_builds():
    """GLENet_S.yaml on Waymo builds at full width on the CPU: 5 input
    channels, the 1504 x 1504 x 40 grid, 188 x 188 x 2 anchors, the
    budgets 80000 / 90000."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(cfg_from_yaml_file(
        str(ROOT / 'configs/waymo_models/GLENet_S.yaml')), device='cpu')
    assert det.num_point_features == 5
    assert det.net.backbone_3d.conv_input.kernel.shape == (27, 5, 16)
    assert tuple(det.grid_size) == (1504, 1504, 40)
    assert det.anchor_set.anchors.shape == (188, 188, 2, 7)
    assert (det.max_voxels_train, det.max_voxels_test) == (80000, 90000)
    assert type(det.net.dense_head).__name__ == 'AnchorHeadKLLabel'


@pytest.fixture(scope='module')
def runs():
    cfg = toy_cfg()
    batch = tp.single_stage_batch(cfg, n_points=1024)
    assert batch['points'].shape[-1] == 5
    with tp.pinned_f32():
        predicts = tp.run_single_stage_predicts(cfg, batch)
        step = tp.run_single_stage_step(cfg, batch, align_relu=True)
    return cfg, batch, predicts, step


def test_stages(runs):
    tp.assert_single_stage_stages(runs[2])


def test_predict_zero_thresholds(runs):
    cfg = runs[0].MODEL.POST_PROCESSING.NMS_CONFIG
    n = min(int(cfg.NMS_POST_MAXSIZE), int(cfg.NMS_PRE_MAXSIZE))
    assert runs[2][0]['pred_zero']['final_valid'].sum(1).min() == n
    tp.assert_single_stage_predict(runs[2], 'pred_zero')


def test_targets(runs):
    tp.assert_single_stage_targets(runs[3])


def test_loss_terms(runs):
    ref, metrics, _, _, _ = runs[3]
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_gradients(runs):
    """Every gradient per tensor within 2e-4 of its largest |gradient|
    (+1e-6).  The train forward of this toy puts some ReLU inputs of the
    backbones within f32 rounding of 0 (the sparse and dense 3D levels hold
    ~1e6 of them), and where rounding puts one on the other side of 0 in
    the other package its mask flips and moves its whole BN channel's
    gradient.  The port's step therefore takes JAX's side at exactly those
    elements, each within 1e-5 of its module's largest |output| on both
    sides (torch_parity.align_relu_kinks, which fails on any larger flip),
    so both packages differentiate one branch; no gradient is excluded."""
    ref, _, grads, _, tdet = runs[3]
    assert ref['relu_flipped'] <= 4, ref['relu_flipped']
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_bn_stats(runs):
    ref, _, _, _, tdet = runs[3]
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


def test_params_after_adam(runs):
    ref, _, grads, _, tdet = runs[3]
    opt = runs[0].OPTIMIZATION
    tp.assert_params_after_adam(tdet, ref, grads,
                                float(opt.LR) / float(opt.DIV_FACTOR))


# ---------------------------------------------------------------------------
# the CLIs on a synthetic Waymo-layout tree
# ---------------------------------------------------------------------------

def _write_cfg(path, root):
    """GLENet_S.yaml with its Waymo data config (augmentations included),
    the toy grid, budget, 2D backbone and NMS, the tree's path, every
    train frame (SAMPLED_INTERVAL 1) and B = 2."""
    with open(ROOT / 'configs/waymo_models/GLENet_S.yaml') as f:
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


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.waymo_dataset import \
        create_waymo_gt_database
    from glenet_tpu_torch.utils import synthetic
    base = tmp_path_factory.mktemp('toy_waymo')
    root = synthetic.write_waymo_tree(base / 'waymo', n_seq=3,
                                      frames_per_seq=2, seed=5,
                                      n_points=6000, vehicles=(3, 5))
    # the toy range is +-9.6 m: move the boxes and their points inside
    for pkl in (root / synthetic.WAYMO_PROCESSED).glob('*/*.pkl'):
        with open(pkl, 'rb') as f:
            infos = pickle.load(f)
        for info in infos:
            npy = pkl.parent / f"{info['point_cloud']['sample_idx']:04d}.npy"
            pts = np.load(npy)
            pts[:, :2] *= 0.125
            np.save(npy, pts)
            a = info['annos']
            a['gt_boxes_lidar'][:, :2] *= 0.125
            a['location'] = a['gt_boxes_lidar'][:, :3]
        with open(pkl, 'wb') as f:
            pickle.dump(infos, f)
    cfg_path = _write_cfg(base / 'toy_glenet_s_waymo.yaml', root)
    cfg = cfg_from_yaml_file(str(cfg_path))
    create_waymo_gt_database(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root)
    synthetic.add_waymo_db_variances(root)
    return root, cfg_path


def test_train_and_test_clis(tree, tmp_path):
    """train (1 epoch x 2 steps at B = 2, then a resume for a second
    epoch), then test on the newest checkpoint: the Waymo AP / APH keys,
    equal to glenet_tpu's evaluator on result.pkl within 1e-3."""
    import math

    from glenet_tpu.eval import waymo_eval as jwe

    from glenet_tpu_torch.datasets.waymo_dataset import WaymoDataset
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train
    root, cfg_path = tree
    out = tmp_path / 'out'
    argv = ['--cfg_file', str(cfg_path), '--output_dir', str(out),
            '--device', 'cpu']
    run = train.main(argv + ['--epochs', '1', '--max_steps_per_epoch', '2'])
    assert [r['it'] for r in run['steps']] == [1, 2]
    for r in run['steps']:
        assert all(math.isfinite(r[k]) for k in (
            'loss', 'loss_cls', 'loss_loc', 'loss_dir', 'loc_loss_src',
            'grad_norm'))
    run = train.main(argv + ['--epochs', '2', '--max_steps_per_epoch', '2'])
    assert run['start_step'] == 2 and [r['it'] for r in run['steps']] == [3,
                                                                         4]
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    logger = logging.getLogger('glenet_tpu_torch.utils.common.rank0')
    logger.addHandler(handler)
    try:
        (path, res), = test_cli.main(argv).items()
    finally:
        logger.removeHandler(handler)
    assert any(ln.startswith('Waymo evaluation: ') for ln in lines)
    assert not any('KITTI' in ln for ln in lines)
    assert path.endswith('checkpoint_epoch_1.pth')
    keys = [f'OBJECT_TYPE_TYPE_VEHICLE_LEVEL_{lv}/{m}' for lv in (1, 2)
            for m in ('AP', 'APH')]
    assert sorted(res['ap']) == sorted(keys)
    with open(out / 'eval' / 'epoch_1' / 'result.pkl', 'rb') as f:
        det_annos = pickle.load(f)
    ds = WaymoDataset(tp.to_port_cfg(yaml.safe_load(cfg_path.read_text()))
                      .DATA_CONFIG, ['Vehicle'], training=False)
    assert len(det_annos) == len(ds) == res['frames'] == 2
    assert sum(len(a['name']) for a in det_annos) > 0
    gt = [dict(i['annos'], boxes_lidar=i['annos']['gt_boxes_lidar'])
          for i in ds.infos]
    _, ref = jwe.waymo_evaluation(det_annos, gt, ['Vehicle'])
    for k in keys:
        assert abs(res['ap'][k] - ref[k]) <= 1e-3, k


def test_first_train_items_match_jax(tree):
    """The port's dataset gives glenet_tpu's items on the CLI tree, with
    the gt sampling and world augmentations of waymo_dataset.yaml."""
    from glenet_tpu.config import cfg_from_yaml_file as jcfg
    from glenet_tpu.datasets.waymo_dataset import WaymoDataset as JDs

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.waymo_dataset import WaymoDataset
    _, cfg_path = tree
    jc, tc = jcfg(str(cfg_path)), cfg_from_yaml_file(str(cfg_path))
    ref = next(JDs(jc.DATA_CONFIG, jc.CLASS_NAMES, seed=0).iter_batches(
        2, seed=0))
    got = next(WaymoDataset(tc.DATA_CONFIG, tc.CLASS_NAMES,
                            seed=0).iter_batches(2, seed=0))
    assert got['frame_id'] == ref['frame_id']
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_convert_weights_waymo(tmp_path):
    """A reference GLENet-S state dict of Waymo's full widths (5 input
    channels) through tools.convert_weights: every key consumed, and the
    checkpoint's weights equal glenet_tpu's converter on the same tensors,
    leaf by leaf."""
    import torch
    from test_torch_weight_converter import _assert_trees_equal

    from glenet_tpu.config import cfg_from_yaml_file as jcfg
    from glenet_tpu.utils import weight_converter as jwc

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.tools import convert_weights
    from glenet_tpu_torch.train import checkpoint as ck
    from glenet_tpu_torch.utils import synthetic
    from glenet_tpu_torch.utils.jax_weights import port_to_jax_variables
    cfg_file = str(ROOT / 'configs/waymo_models/GLENet_S.yaml')
    tcfg = cfg_from_yaml_file(cfg_file)
    sd = synthetic.pcdet_state_dict(tcfg, seed=9)
    assert sd['backbone_3d.conv_input.0.weight'].shape == (16, 3, 3, 3, 5)
    pth = tmp_path / 'glenet_s_waymo.pth'
    torch.save({'model_state': sd, 'epoch': 30}, pth)
    path, report = convert_weights.main([
        '--cfg_file', cfg_file, '--torch_ckpt', str(pth),
        '--output_dir', str(tmp_path / 'ckpt'), '--device', 'cpu'])
    assert report == {'converted': ['backbone_3d', 'backbone_2d',
                                    'dense_head'], 'unconsumed': []}
    tdet = build_detector(tcfg, device='cpu')
    template = port_to_jax_variables(tdet.net)
    tdet.net.load_state_dict(ck.load_checkpoint(path)['model_state'])
    ref, _ = jwc.convert_full_model(
        jcfg(cfg_file), {k: v.numpy() for k, v in sd.items()}, template)
    _assert_trees_equal(port_to_jax_variables(tdet.net), ref)
