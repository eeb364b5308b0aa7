"""One train step of PartA2 (PartA2Net) and PartA2-free (PointRCNN with
UNetV2) in the port against glenet_tpu on the toy configs of
tests/test_parta2.py, one set of numpy-drawn weights and points, f32 on both
sides, JAX's RoI targets and dropout draws (DP_RATIO 0.3) fed to the port:
every loss term rtol 1e-4, every gradient within 2e-4 of its parameter's
largest, every BN statistic rtol 1e-4 / atol 1e-5."""
import pytest

jax = pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402
from test_torch_parta2_detector import _cfg  # noqa: E402


@pytest.mark.parametrize('kind', ['PartA2', 'PartA2_free'])
def test_train_step(kind):
    with tp.pinned_f32():
        ref, metrics, grads, tdet = tp.run_train_steps(_cfg(kind),
                                                       dropout=True)
    assert ref['targets']['reg_valid_mask'].any(), 'fg rois expected'
    assert {'rcnn_loss_cls', 'rcnn_loss_reg', 'point_loss_part'} <= set(
        metrics)
    tp.assert_loss_terms_equal(metrics, ref['metrics'])
    tp.assert_grads_equal(grads, ref['grads'], tdet)
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """A synthetic KITTI-layout tree (4 train + 2 val frames of 6000
    points, cars inside the toy range) with its infos."""
    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.utils import synthetic
    base = tmp_path_factory.mktemp('parta2_kitti')
    root = synthetic.write_kitti_tree(
        base / 'kitti', n_train=4, n_val=2, seed=3, n_points=6000,
        cars=(2, 3), x_range=(6.0, 14.0), y_half=6.0, ground_radius=20.0)
    data = _data_cfg(root)
    create_kitti_infos(Cfg(data), ['Car'], root, root)
    return base, root


def _data_cfg(root):
    """kitti_dataset.yaml on the toy range and voxels, without gt
    sampling (the tree's database holds no label variances)."""
    from pathlib import Path

    import yaml
    repo = Path(__file__).resolve().parent.parent
    with open(repo / 'configs/dataset_configs/kitti_dataset.yaml') as f:
        data = yaml.safe_load(f)
    data['DATA_AUGMENTOR']['DISABLE_AUG_LIST'] = ['gt_sampling']
    data.update(DATA_PATH=str(root), POINT_CLOUD_RANGE=[0, -8, -1.2, 16, 8,
                                                        1.2],
                MAX_POINTS_PER_SCENE=4096, MAX_GT_PER_SCENE=16)
    data['DATA_PROCESSOR'][-1] = {
        'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': [0.5, 0.5, 0.1],
        'MAX_POINTS_PER_VOXEL': 5,
        'MAX_NUMBER_OF_VOXELS': {'train': 512, 'test': 512}}
    return data


@pytest.mark.parametrize('kind', ['PartA2', 'PartA2_free'])
def test_train_and_test_clis(kind, tree):
    """The port's train CLI (1 epoch x 2 steps, B = 2) and test CLI on the
    toy configs over the synthetic tree, on the CPU: finite losses with the
    part head's and the RCNN's terms, a checkpoint, the Car AP keys."""
    import json
    import math

    import yaml

    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train
    base, root = tree
    cfg = json.loads(json.dumps(_cfg(kind)))
    cfg['DATA_CONFIG'] = _data_cfg(root)
    path = base / f'{kind}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    out = base / f'out_{kind}'
    run = train.main(['--cfg_file', str(path), '--output_dir', str(out),
                      '--epochs', '1', '--max_steps_per_epoch', '2',
                      '--device', 'cpu'])
    assert len(run['steps']) == 2 and len(run['checkpoints']) == 1
    for step in run['steps']:
        assert {'point_loss_part', 'rcnn_loss_cls', 'rcnn_loss_reg'} <= set(
            step)
        assert all(math.isfinite(v) for v in step.values()
                   if isinstance(v, float)), step
    results = test_cli.main(['--cfg_file', str(path), '--output_dir',
                             str(out), '--device', 'cpu'])
    (_, res), = results.items()
    assert res['frames'] == 2
    assert 'Car_3d/moderate_R40' in res['ap']
