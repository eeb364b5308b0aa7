"""Trained weights and the CLIs for KITTI's three-class detectors in
the port, on the CPU:

  - the port's converter of reference (pcdet) checkpoints equals
    glenet_tpu's, leaf by leaf and report by report, on
    utils/synthetic.pcdet_state_dict at full width for pointpillar.yaml
    (vfe.pfn_layers, every key consumed) and second_iou.yaml (stage 1;
    SECONDHead's keys unconsumed, as glenet_tpu leaves them); both refuse
    second_multihead.yaml's AnchorHeadMulti;
  - `tools.train` (1 epoch x 2 steps) on a toy PointPillars with
    pointpillar_newaugs.yaml's augmentations over a synthetic three-class
    tree, then `tools.test` with the three-class KITTI evaluation."""
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from test_torch_weight_converter import _assert_trees_equal  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CLASSES = ('Car', 'Pedestrian', 'Cyclist')


@pytest.mark.parametrize('name', ['pointpillar.yaml', 'second_iou.yaml'])
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
    if name == 'pointpillar.yaml':
        assert report == {'converted': ['vfe', 'backbone_2d', 'dense_head'],
                          'unconsumed': []}
    else:
        assert report['converted'] == ['backbone_3d', 'backbone_2d',
                                       'dense_head']
        assert report['unconsumed'] == sorted(
            k for k in sd if k.startswith('roi_head.')
            and 'num_batches_tracked' not in k)
    load_jax_variables(det.net, got)
    if name == 'pointpillar.yaml':
        torch.testing.assert_close(
            det.net.vfe.PFNLayer_0.Dense_0.weight,
            torch.from_numpy(sd['vfe.pfn_layers.0.linear.weight']),
            rtol=0, atol=0)


def test_converters_refuse_the_multihead():
    """Neither package converts AnchorHeadMulti: glenet_tpu fails on the
    missing dense_head.conv_cls, the port refuses it by name first."""
    from glenet_tpu.config import cfg_from_yaml_file
    from glenet_tpu.utils import weight_converter as jwc

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils import synthetic
    from glenet_tpu_torch.utils import weight_converter as wc
    from glenet_tpu_torch.utils.jax_weights import port_to_jax_variables
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/'
                                        'second_multihead.yaml'))
    tcfg = tp.to_port_cfg(cfg)
    sd = {k: v.numpy() for k, v in synthetic.pcdet_state_dict(
        tp.to_port_cfg(cfg_from_yaml_file(str(
            ROOT / 'configs/kitti_models/second.yaml'))), seed=1).items()
        if not k.startswith('dense_head.')}
    template = port_to_jax_variables(build_detector(tcfg, device='cpu').net)
    with pytest.raises(KeyError, match='conv_cls'):
        jwc.convert_full_model(cfg, sd, template)
    with pytest.raises(NotImplementedError, match='AnchorHeadMulti'):
        wc.convert_full_model(tcfg, sd, template)


def _three_class_tree(base, seed):
    from glenet_tpu_torch.utils import synthetic
    return synthetic.write_kitti_tree(
        base / 'kitti', n_train=4, n_val=2, seed=seed, n_points=6000,
        cars=(3, 4), x_range=(6.0, 15.0), y_half=7.0, ground_radius=20.0,
        three_class=True)


def _write_pillar_cfg(tmp_path, root):
    """The toy PointPillars with pointpillar_newaugs.yaml's data config
    (its augmentation queue, 4 sampled boxes per class) on the toy range
    over the tree at `root`; infos written."""
    from test_torch_train_cli import RANGE

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    cfg = json.loads(json.dumps(tp.tiny_single_stage_cfg('PILLAR')))
    with open(ROOT / 'configs/dataset_configs/kitti_dataset.yaml') as f:
        data = yaml.safe_load(f)
    with open(ROOT / 'configs/kitti_models/pointpillar_newaugs.yaml') as f:
        data['DATA_AUGMENTOR'] = yaml.safe_load(f)['DATA_CONFIG'][
            'DATA_AUGMENTOR']
    data['DATA_AUGMENTOR']['AUG_CONFIG_LIST'][0]['SAMPLE_GROUPS'] = [
        f'{c}:4' for c in CLASSES]
    data.update(DATA_PATH=str(root), POINT_CLOUD_RANGE=RANGE,
                MAX_POINTS_PER_SCENE=4096, MAX_GT_PER_SCENE=24)
    data['DATA_PROCESSOR'][-1] = cfg['DATA_CONFIG']['DATA_PROCESSOR'][0]
    cfg['DATA_CONFIG'] = data
    path = tmp_path / 'toy_pointpillar.yaml'
    path.write_text(yaml.safe_dump(cfg))
    c = cfg_from_yaml_file(str(path))
    create_kitti_infos(c.DATA_CONFIG, c.CLASS_NAMES, root, root)
    return path


def test_train_then_test_cli_three_classes(tmp_path):
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train
    root = _three_class_tree(tmp_path, 2)
    cfg_path = _write_pillar_cfg(tmp_path, root)
    out = tmp_path / 'out'
    run = train.main(['--cfg_file', str(cfg_path), '--output_dir', str(out),
                      '--epochs', '1', '--max_steps_per_epoch', '2',
                      '--device', 'cpu'])
    assert len(run['steps']) == 2
    for rec in run['steps']:
        for k in ('loss', 'loss_cls', 'loss_loc', 'loss_dir', 'grad_norm'):
            assert np.isfinite(rec[k]), k
    results = test_cli.main(['--cfg_file', str(cfg_path), '--output_dir',
                             str(out), '--device', 'cpu'])
    (path, res), = results.items()
    assert path.endswith('checkpoint_epoch_0.pth') and res['frames'] == 2
    for c in CLASSES:
        for diff in ('easy', 'moderate', 'hard'):
            assert 0.0 <= res['ap'][f'{c}_3d/{diff}_R40'] <= 100.0
