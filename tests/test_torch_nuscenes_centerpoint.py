"""The slice as a whole on the CPU: the nuScenes CenterPoint path of the
port against glenet_tpu, and the nuScenes / Lyft / Pandaset configs
through the port's CLIs.

  - the three run-time configs, written as yaml by config.write_run_cfg
    and read back by cfg_from_yaml_file as every CLI reads them, build at
    full width: nuScenes CenterPoint (VoxelResBackBone8x on the 1024 x 1024 x 40
    grid, one CenterHead group of the 10 classes), Lyft SECOND-multihead
    with the sin/cos coder (1600 x 1600 x 40, code size 8) and Pandaset
    SECOND (2800 x 1600 x 40);
  - a toy CenterPoint (nuscenes_parity.toy_cfg: the nuScenes run-time
    config on a +-9.6 m range, 512 voxels, a narrow 2D backbone) over 2
    frames of a tiny nuScenes tree (10 sweeps each, drawn from seed 0),
    same numpy-drawn weights through utils/jax_weights, f32 on both
    sides: voxels and every backbone level (integers exactly, features
    rtol 1e-4 / atol 1e-5), a predict at the published thresholds and at
    zero thresholds (labels and valid flags exactly, boxes and scores rtol
    1e-4 / atol 1e-4; where two decoded scores tie within rounding,
    torch_parity.assert_single_stage_predict holds the top-k and the final
    NMS stage by stage), and one train step: the CenterHead targets (as
    tests/test_torch_centerpoint.py), every loss term rtol 1e-4, every
    gradient as its assert_center_grads (the port taking JAX's side of
    ReLU kinks within rounding of 0, at the BN outputs and at the
    residual sums h + x), BN stats rtol 1e-4 / atol 1e-5;
  - `tools.train` (1 epoch x 2 steps, B = 2, gt sampling and world
    augmentations) and `tools.test` with --device cpu on tiny trees: the
    NDS keys (nuScenes), the Lyft mAP keys and the KITTI AP keys
    (Pandaset); the first nuScenes training batch equals the one
    glenet_tpu's CLI draws after its example batch."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402
import nuscenes_parity as npar  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NAME = 'nuscenes_centerpoint'


@pytest.mark.parametrize('name,grid,code_size', [
    ('nuscenes_centerpoint', (1024, 1024, 40), 7),
    ('lyft_second_multihead', (1600, 1600, 40), 8),
    ('pandaset_second', (2800, 1600, 40), 7)])
def test_runtime_configs_build(name, grid, code_size, tmp_path):
    from glenet_tpu_torch.config import cfg_from_yaml_file, write_run_cfg
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = cfg_from_yaml_file(write_run_cfg(name, tmp_path / f'{name}.yaml'))
    assert cfg.TAG == name
    det = build_detector(cfg, device='cpu')
    assert tuple(det.grid_size) == grid
    assert det.box_coder.code_size == code_size
    head = det.net.dense_head
    if name == 'nuscenes_centerpoint':
        assert det.net.backbone_3d.residual
        assert head.hm_1.weight.shape[0] == 10
    else:
        assert det.num_point_features == (5 if 'lyft' in name else 4)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = npar.nusc_tree(tmp_path_factory.mktemp('nusc_model') / 'nusc')
    cfg = npar.toy_cfg(NAME, root)
    batch = npar.tree_batch(cfg, root)
    with tp.pinned_f32():
        predicts = tp.run_single_stage_predicts(cfg, batch)
        step = tp.run_single_stage_step(cfg, batch, align_relu=True)
    return cfg, batch, predicts, step


def test_stages(runs):
    _, batch, predicts, _ = runs
    assert batch['points'].shape == (2, 4096, 5)
    # the key frame and its sweeps in order, up to MAX_POINTS_PER_SCENE
    assert len(np.unique(batch['points'][0, :, 4])) > 5
    tp.assert_single_stage_stages(predicts)
    assert predicts[1]['full']['dense_head']['hm'].shape == (2, 24, 24, 10)


@pytest.mark.parametrize('key', ['pred', 'pred_zero'])
def test_predict(runs, key):
    ref = runs[2][0][key]
    assert ref['final_valid'].sum(1).min() > (0 if key == 'pred' else 10)
    tp.assert_single_stage_predict(runs[2], key)


def test_targets(runs):
    ref, _, _, targets, _ = runs[3]
    ref = ref['targets']
    for k in ('inds', 'mask'):
        np.testing.assert_array_equal(targets[k], ref[k])
    assert ref['mask'].sum() == runs[1]['gt_mask'].sum()
    hm, hm_r = targets['heatmap'], ref['heatmap']
    np.testing.assert_array_equal(hm == 1.0, hm_r == 1.0)
    np.testing.assert_allclose(hm, hm_r, rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(targets['target_boxes'], ref['target_boxes'],
                               rtol=0, atol=1e-6)


def test_loss_and_gradients(runs):
    from test_torch_centerpoint import assert_center_grads
    ref, metrics, grads, _, tdet = runs[3]
    assert set(ref['metrics']) == {'loss', 'loss_cls', 'loss_loc',
                                   'grad_norm'}
    tp.assert_loss_terms_equal(metrics, ref['metrics'])
    assert ref['relu_flipped'] <= 8, ref['relu_flipped']
    # seeds 0-9 of tree_batch flip at most one element of a residual sum
    assert ref['residual_flipped'] <= 4, ref['residual_flipped']
    assert_center_grads(grads, ref['grads'], tdet)
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


# ---------------------------------------------------------------------------
# the CLIs on tiny trees
# ---------------------------------------------------------------------------

TREES = {'nuscenes_centerpoint': lambda p: npar.nusc_tree(p),
         'lyft_second_multihead': lambda p: npar.nusc_tree(p, lyft=True,
                                                           seed=3),
         'pandaset_second': lambda p: npar.pandaset_tree(p)}


def _write_cli_cfg(name, tmp_path):
    """toy_cfg of `name` with its augmentations (data_dict) over a tiny
    tree, B = 2, as a yaml file."""
    import yaml
    root = TREES[name](tmp_path / 'data')
    cfg = json.loads(json.dumps(npar.toy_cfg(name, root)))
    cfg['DATA_CONFIG'] = npar.data_dict(name, root)
    cfg['MODEL']['POST_PROCESSING']['SCORE_THRESH'] = 0.0
    path = tmp_path / f'toy_{name}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return path


METRIC_KEYS = {'nuscenes_centerpoint': ('NDS', 'mAP', 'car_AP_2.0'),
               'lyft_second_multihead': ('mAP', 'car_mAP'),
               'pandaset_second': ('Car_3d/moderate_R40',)}


@pytest.mark.parametrize('name', list(TREES))
def test_train_and_test_clis(name, tmp_path):
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train
    cfg_path = _write_cli_cfg(name, tmp_path)
    argv = ['--cfg_file', str(cfg_path), '--output_dir',
            str(tmp_path / 'out'), '--device', 'cpu']
    run = train.main(argv + ['--epochs', '1', '--max_steps_per_epoch', '2'])
    assert [r['it'] for r in run['steps']] == [1, 2]
    for r in run['steps']:
        assert all(math.isfinite(r[k]) for k in ('loss', 'loss_cls',
                                                 'loss_loc', 'grad_norm'))
    (path, res), = test_cli.main(argv).items()
    assert path.endswith('checkpoint_epoch_0.pth') and res['frames'] == 3
    for k in METRIC_KEYS[name]:
        assert math.isfinite(res['ap'][k]), k


def test_first_train_batch_matches_jax_cli(tmp_path, monkeypatch):
    """The port's train CLI trains first on the batch glenet_tpu's CLI
    draws after its example batch (sweeps, gt sampling and world
    augmentations from the same streams)."""
    from glenet_tpu.config import cfg_from_yaml_file
    from glenet_tpu.datasets import build_dataset

    from glenet_tpu_torch.tools import train
    from glenet_tpu_torch.train import state as state_lib
    cfg_path = _write_cli_cfg(NAME, tmp_path)
    cfg = cfg_from_yaml_file(str(cfg_path))
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    ds = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True,
                       seed=0)
    example = next(ds.iter_batches(b, seed=0))
    ref = next(ds.iter_batches(b, seed=0))
    seen = []
    real = state_lib.make_train_step

    def make_train_step(detector, tx):
        step = real(detector, tx)

        def capture(ts, batch):
            seen.append({k: v.numpy() for k, v in batch.items()})
            return step(ts, batch)
        return capture

    monkeypatch.setattr(state_lib, 'make_train_step', make_train_step)
    train.main(['--cfg_file', str(cfg_path), '--output_dir',
                str(tmp_path / 'out'), '--device', 'cpu', '--epochs', '1',
                '--max_steps_per_epoch', '1'])
    assert len(seen) == 1
    assert not np.array_equal(seen[0]['points'], example['points'])
    arrays = {k: v for k, v in ref.items() if isinstance(v, np.ndarray)}
    assert set(seen[0]) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(seen[0][k], v, err_msg=k)
