"""The port's `train` and `test` CLIs end to end on the CPU (--device cpu):
the toy two-stage GLENet-VR topology with GLENet-VR's augmentations (gt
sampling, world flip / rotation / scaling) on a synthetic tree in KITTI's
layout (utils/synthetic.write_kitti_tree) whose cars lie inside the toy
range, with label variances in its infos and gt database.

  1. train 2 epochs x 2 steps: 2 checkpoints, finite losses;
  2. resume for a third epoch with --bn_refresh 2 and --eval_after_train:
     the run starts at step 4, writes the third checkpoint, and the BN
     stats of that checkpoint are the refreshed ones;
  3. `test` on the newest checkpoint: result.pkl and the AP dict.

test_torch_guard.py checks that both CLIs raise without a card unless
--device cpu is given."""
import json
import math
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import torch_parity as tp

ROOT = Path(__file__).resolve().parent.parent
RANGE = [0, -8, -3, 16, 8, 1]          # the toy grid on KITTI's z range


def _write_cfg(tmp_path, root):
    cfg = json.loads(json.dumps(tp.tiny_twostage_cfg(512)))
    with open(ROOT / 'configs/dataset_configs/kitti_dataset.yaml') as f:
        data = yaml.safe_load(f)
    with open(ROOT / 'configs/kitti_models/GLENet_VR.yaml') as f:
        data['DATA_AUGMENTOR'] = yaml.safe_load(f)['DATA_CONFIG'][
            'DATA_AUGMENTOR']
    data['DATA_AUGMENTOR']['AUG_CONFIG_LIST'][0]['SAMPLE_GROUPS'] = ['Car:4']
    data.update(DATA_PATH=str(root), POINT_CLOUD_RANGE=RANGE,
                MAX_POINTS_PER_SCENE=4096, MAX_GT_PER_SCENE=16)
    data['DATA_PROCESSOR'][-1] = cfg['DATA_CONFIG']['DATA_PROCESSOR'][0]
    cfg['DATA_CONFIG'] = data
    cfg['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'][0][
        'anchor_bottom_heights'] = [-1.73]
    path = tmp_path / 'toy_glenet_vr.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.utils import synthetic
    base = tmp_path_factory.mktemp('toy_kitti')
    root = synthetic.write_kitti_tree(
        base / 'kitti', n_train=4, n_val=2, seed=3, n_points=6000,
        cars=(2, 3), x_range=(6.0, 14.0), y_half=6.0, ground_radius=20.0)
    cfg_path = _write_cfg(base, root)
    cfg = cfg_from_yaml_file(str(cfg_path))
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    synthetic.add_label_variances(root, seed=4)
    return root, cfg_path


def _train(cfg_path, out, *extra):
    from glenet_tpu_torch.tools import train
    return train.main(['--cfg_file', str(cfg_path), '--output_dir', str(out),
                       '--max_steps_per_epoch', '2', '--device', 'cpu',
                       *extra])


def test_train_resume_and_test(tree, tmp_path):
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.train import checkpoint as ck
    from glenet_tpu_torch.train.bn_refresh import bn_stats
    root, cfg_path = tree
    out = tmp_path / 'out'

    run = _train(cfg_path, out, '--epochs', '2')
    assert run['start_step'] == 0 and len(run['steps']) == 4
    assert sorted(p.name for p in (out / 'ckpt').iterdir()) == [
        'checkpoint_epoch_0.pth', 'checkpoint_epoch_1.pth']
    for rec in run['steps']:
        assert all(math.isfinite(rec[k]) for k in
                   ('loss', 'loss_cls', 'loss_loc', 'rcnn_loss_reg',
                    'grad_norm'))
        assert rec['data_ms'] > 0 and rec['step_ms'] > 0
    saved = ck.load_checkpoint(out / 'ckpt' / 'checkpoint_epoch_1.pth')
    assert (saved['epoch'], saved['it'], saved['step']) == (1, 4, 4)

    run = _train(cfg_path, out, '--epochs', '3', '--bn_refresh', '2',
                 '--eval_after_train')
    assert run['start_step'] == 4
    assert [r['it'] for r in run['steps']] == [5, 6]
    assert len(list((out / 'ckpt').iterdir())) == 3
    last = ck.load_checkpoint(out / 'ckpt' / 'checkpoint_epoch_2.pth')
    assert last['step'] == 6
    refreshed = bn_stats(run['detector'].net)
    for k, v in refreshed.items():
        assert torch.equal(last['model_state'][k], v.cpu()), k
    assert 'Car_3d/moderate_R40' in run['eval']['ap']

    results = test_cli.main(['--cfg_file', str(cfg_path), '--output_dir',
                             str(out), '--device', 'cpu'])
    (path, res), = results.items()
    assert path.endswith('checkpoint_epoch_2.pth')
    with open(out / 'eval' / 'epoch_2' / 'result.pkl', 'rb') as f:
        det_annos = pickle.load(f)
    assert len(det_annos) == res['frames'] == 2
    assert {a['frame_id'] for a in det_annos} == {'000004', '000005'}
    for key in ('3d', 'bev', 'image'):
        for diff in ('easy', 'moderate', 'hard'):
            v = res['ap'][f'Car_{key}/{diff}_R40']
            assert 0.0 <= v <= 100.0
    assert res['sec_per_frame'] > 0 and res['eval_sec'] > 0
    assert set(res['recall']) == {0.3, 0.5, 0.7}


def test_first_train_batch_matches_jax_cli(tree, tmp_path, monkeypatch):
    """The first batch the port's train CLI trains on equals the JAX CLI's
    on the same tree and seed: both draw the example batch first (which
    initialises the JAX train state), and that moves the dataset's and the
    augmentor's random streams."""
    from glenet_tpu.config import cfg_from_yaml_file
    from glenet_tpu.datasets import build_dataset

    from glenet_tpu_torch.train import state as state_lib
    _, cfg_path = tree
    cfg = cfg_from_yaml_file(str(cfg_path))
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    ds = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True,
                       seed=0)
    example = next(ds.iter_batches(b, seed=0))
    ref = next(ds.iter_batches(b, seed=0))     # epoch 0's first batch
    seen = []
    real = state_lib.make_train_step

    def make_train_step(detector, tx):
        step = real(detector, tx)

        def capture(ts, batch):
            seen.append({k: v.numpy() for k, v in batch.items()})
            return step(ts, batch)
        return capture

    monkeypatch.setattr(state_lib, 'make_train_step', make_train_step)
    _train(cfg_path, tmp_path / 'out', '--epochs', '1',
           '--max_steps_per_epoch', '1')
    assert len(seen) == 1
    assert not np.array_equal(seen[0]['points'], example['points'])
    arrays = {k: v for k, v in ref.items() if isinstance(v, np.ndarray)}
    assert set(seen[0]) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(seen[0][k], v, err_msg=k)


def test_test_cli_draws_the_example_batch(tree, tmp_path, monkeypatch):
    """The port's test CLI draws the JAX CLI's example batch (in order, no
    padding dropped) before its evaluation, so the test split's
    subsampling of scenes above MAX_POINTS_PER_SCENE takes the same number
    of draws.  Both packages seed that split's stream from the OS, so the
    batches themselves cannot be compared."""
    from glenet_tpu_torch.datasets.kitti_dataset import KittiDataset
    from glenet_tpu_torch.tools import test as test_cli
    _, cfg_path = tree
    out = tmp_path / 'out'
    _train(cfg_path, out, '--epochs', '1', '--max_steps_per_epoch', '1')
    calls = []
    real = KittiDataset.iter_batches

    def iter_batches(self, batch_size, **kw):
        calls.append((self.training, kw))
        return real(self, batch_size, **kw)

    monkeypatch.setattr(KittiDataset, 'iter_batches', iter_batches)
    test_cli.main(['--cfg_file', str(cfg_path), '--output_dir', str(out),
                   '--device', 'cpu'])
    order = {'shuffle': False, 'drop_last': False}
    # the evaluation strides the split over the processes (one here)
    assert calls == [(False, order), (False, dict(order, process_rank=0,
                                                   process_count=1))]


def test_synthetic_tree(tree):
    """The fixture tree: every car labelled, inside the camera's view and
    the toy range, with its label variances in the infos and the gt
    database."""
    root, _ = tree
    with open(root / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
        db = pickle.load(f)
    n_cars = 0
    for info in infos:
        annos = info['annos']
        cars = annos['name'] == 'Car'
        boxes = annos['gt_boxes_lidar'][:int(cars.sum())]
        assert (boxes[:, 0] > RANGE[0]).all() and (boxes[:, 0] < RANGE[3]).all()
        assert (np.abs(boxes[:, 1]) < RANGE[4]).all()
        assert (annos['num_points_in_gt'][cars] > 100).all()
        unc = annos['uncertainty']
        assert ((unc[cars] >= 0.01) & (unc[cars] < 0.2)).all()
        assert (unc[~cars] == -1).all()
        n_cars += int(cars.sum())
    assert len(db['Car']) == n_cars
    assert all(((d['uncertainty'] >= 0.01) & (d['uncertainty'] < 0.2)).all()
               for d in db['Car'])
