"""Trained weights and the CLIs for the port's single-stage family, on the
CPU:

  - the port's converter of reference (pcdet) checkpoints equals
    glenet_tpu's, leaf by leaf, on utils/synthetic.pcdet_state_dict at full
    width for GLENet_S.yaml, GLENet_C.yaml and second.yaml (VoxelBackBone8x
    or Ciassd, BaseBEVBackbone or SSFA with its ZeroPad2d-shifted indices
    and k3 s2 p1 op1 deconvolutions, conv_box_std / conv_iou), every key
    consumed; the converted tree loads into the port;
  - `convert_weights` -> `tools.test --ckpt` on a toy GLENet-C;
  - a toy GLENet-S checkpoint saved by glenet_tpu.train.checkpoint gives
    JAX's predict through the port's .msgpack reader, and goes through
    `tools.test --ckpt`;
  - `tools.train` (1 epoch x 2 steps) then `tools.test` on a toy GLENet-C
    over a synthetic tree in KITTI's layout with label variances."""
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from test_torch_weight_converter import _assert_trees_equal  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize('name', ['GLENet_S.yaml', 'GLENet_C.yaml',
                                  'second.yaml'])
def test_converters_agree_full_width(name):
    from glenet_tpu.config import cfg_from_yaml_file
    from glenet_tpu.utils import weight_converter as jwc

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils import synthetic
    from glenet_tpu_torch.utils import weight_converter as wc
    from glenet_tpu_torch.utils.jax_weights import (load_jax_variables,
                                                    port_to_jax_variables)
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models' / name))
    tcfg = tp.to_port_cfg(cfg)
    det = build_detector(tcfg, device='cpu')
    template = port_to_jax_variables(det.net)
    sd = {k: v.numpy() for k, v in
          synthetic.pcdet_state_dict(tcfg, seed=1).items()}
    ref, ref_report = jwc.convert_full_model(cfg, sd, template)
    got, report = wc.convert_full_model(tcfg, sd, template)
    _assert_trees_equal(got, ref)
    assert report == ref_report
    assert report == {'converted': ['backbone_3d', 'backbone_2d',
                                    'dense_head'], 'unconsumed': []}
    load_jax_variables(det.net, got)
    if name == 'GLENet_C.yaml':
        torch.testing.assert_close(
            det.net.backbone_2d.deconv_0.weight,
            torch.from_numpy(sd['backbone_2d.deconv_block_0.0.weight']),
            rtol=0, atol=0)


def _kitti_tree(base, seed):
    from glenet_tpu_torch.utils import synthetic
    return synthetic.write_kitti_tree(
        base / 'kitti', n_train=4, n_val=2, seed=seed, n_points=6000,
        cars=(2, 3), x_range=(6.0, 14.0), y_half=6.0, ground_radius=20.0)


def _write_cfg(tmp_path, root, kind):
    """A toy single-stage config (tiny_single_stage_cfg(kind)) with
    KITTI's data config as GLENet_C.yaml sets it (4 sampled cars) on the
    toy range, over the tree at `root`; infos written."""
    from test_torch_train_cli import RANGE

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    cfg = json.loads(json.dumps(tp.tiny_single_stage_cfg(kind)))
    with open(ROOT / 'configs/dataset_configs/kitti_dataset.yaml') as f:
        data = yaml.safe_load(f)
    with open(ROOT / 'configs/kitti_models/GLENet_C.yaml') as f:
        data['DATA_AUGMENTOR'] = yaml.safe_load(f)['DATA_CONFIG'][
            'DATA_AUGMENTOR']
    data['DATA_AUGMENTOR']['AUG_CONFIG_LIST'][0]['SAMPLE_GROUPS'] = ['Car:4']
    data.update(DATA_PATH=str(root), POINT_CLOUD_RANGE=RANGE,
                MAX_POINTS_PER_SCENE=4096, MAX_GT_PER_SCENE=16)
    data['DATA_PROCESSOR'][-1] = cfg['DATA_CONFIG']['DATA_PROCESSOR'][0]
    cfg['DATA_CONFIG'] = data
    cfg['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'][0][
        'anchor_bottom_heights'] = [-1.73]
    path = tmp_path / f'toy_glenet_{kind.lower()}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    c = cfg_from_yaml_file(str(path))
    create_kitti_infos(c.DATA_CONFIG, c.CLASS_NAMES, root, root)
    return path


def test_convert_weights_cli_then_test(tmp_path):
    """A reference .pth of a toy GLENet-C through the port's convert_weights
    CLI, then `tools.test --ckpt`."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.tools import convert_weights
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.train import checkpoint as ck
    from glenet_tpu_torch.utils import synthetic
    root = _kitti_tree(tmp_path, 5)
    cfg_path = _write_cfg(tmp_path, root, 'C')
    sd = synthetic.pcdet_state_dict(cfg_from_yaml_file(str(cfg_path)),
                                    seed=3)
    pth = tmp_path / 'pcdet.pth'
    torch.save({'model_state': sd, 'epoch': 7}, pth)
    out = tmp_path / 'out'
    path, report = convert_weights.main([
        '--cfg_file', str(cfg_path), '--torch_ckpt', str(pth),
        '--output_dir', str(out / 'ckpt'), '--device', 'cpu'])
    assert Path(path).name == 'checkpoint_epoch_7.pth'
    assert report['unconsumed'] == []
    state = ck.load_checkpoint(path)['model_state']
    torch.testing.assert_close(state['dense_head.conv_iou.weight'],
                               sd['dense_head.conv_iou.weight'], rtol=0,
                               atol=0)
    results = test_cli.main(['--cfg_file', str(cfg_path), '--ckpt', path,
                             '--output_dir', str(out), '--device', 'cpu'])
    (got_path, res), = results.items()
    assert got_path == path and res['frames'] == 2
    assert 'Car_3d/moderate_R40' in res['ap']


def test_msgpack_glenet_s(tmp_path):
    """glenet_tpu.train.checkpoint writes a toy GLENet-S checkpoint; the
    port's reader builds a detector whose predict equals JAX's on the
    saved variables (at zero thresholds, every candidate live), and
    `tools.test --ckpt` evaluates the .msgpack."""
    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.train import checkpoint as ckpt_lib
    from glenet_tpu.train import optim, state as state_lib

    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.train import jax_checkpoint
    root = _kitti_tree(tmp_path, 6)
    cfg_path = _write_cfg(tmp_path, root, 'S')
    cfg = tp.tiny_single_stage_cfg('S')
    batch = tp.single_stage_batch(cfg, n_points=1024, seed=8)
    det = jax_build(cfg)
    variables = tp.random_variables(jax.eval_shape(
        det.init, jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch)),
        seed=7)
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    params = jax.tree.map(jnp.asarray, variables['params'])
    ts = state_lib.TrainState(
        step=jnp.asarray(12, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables['batch_stats']),
        opt_state=tx.init(params))
    path = ckpt_lib.save_checkpoint(ckpt_lib.checkpoint_state(ts, 3, 12),
                                    tmp_path / 'jax_ckpt', 3)
    zero = tp.zero_thresholds(cfg)
    tdet = jax_checkpoint.build_detector_from_checkpoint(
        tp.to_port_cfg(zero), path, device='cpu')
    with tp.pinned_f32():
        _, jax_pred, _, pred, _ = tp.run_predicts(zero, variables=variables,
                                                  tdet=tdet, seed=8)
    tp.assert_predict_equal(pred, jax_pred)
    results = test_cli.main(['--cfg_file', str(cfg_path), '--ckpt',
                             str(path), '--output_dir', str(tmp_path / 'out'),
                             '--device', 'cpu'])
    (got_path, res), = results.items()
    assert got_path == str(path) and res['frames'] == 2
    assert (tmp_path / 'out' / 'eval' / 'epoch_3' / 'result.pkl').exists()


def test_train_then_test_cli(tmp_path):
    """tools.train on a toy GLENet-C, 1 epoch x 2 steps (the KL-label and
    IoU losses finite), then tools.test on its checkpoint."""
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train
    from glenet_tpu_torch.utils import synthetic
    root = _kitti_tree(tmp_path, 3)
    cfg_path = _write_cfg(tmp_path, root, 'C')
    synthetic.add_label_variances(root, seed=4)
    out = tmp_path / 'out'
    run = train.main(['--cfg_file', str(cfg_path), '--output_dir', str(out),
                      '--epochs', '1', '--max_steps_per_epoch', '2',
                      '--device', 'cpu'])
    assert len(run['steps']) == 2
    for rec in run['steps']:
        for k in ('loss', 'loss_cls', 'loss_loc', 'loss_dir', 'loss_iou',
                  'loc_loss_src', 'loc_loss_square', 'loc_loss_log',
                  'grad_norm'):
            assert np.isfinite(rec[k]), k
    assert [p.name for p in (out / 'ckpt').iterdir()] == [
        'checkpoint_epoch_0.pth']
    results = test_cli.main(['--cfg_file', str(cfg_path), '--output_dir',
                             str(out), '--device', 'cpu'])
    (path, res), = results.items()
    assert path.endswith('checkpoint_epoch_0.pth') and res['frames'] == 2
    assert 0.0 <= res['ap']['Car_3d/moderate_R40'] <= 100.0
