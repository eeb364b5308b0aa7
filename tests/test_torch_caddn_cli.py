"""CaDDN through the port's CLIs and harness on the CPU (--device cpu): the
toy CaDDN model on a synthetic tree in KITTI's layout with image_2 /
depth_2 PNGs (utils/synthetic.write_kitti_tree(camera=True)):

  1. `tools.train` 1 epoch x 2 steps at B = 2 (random_image_flip on, the
     camera items through the dataset, collation and the train step):
     a checkpoint, finite losses with loss_depth;
  2. `tools.test` on it: result.pkl and the KITTI AP dict;
  3. `tools.convergence_caddn` for 2 steps on the toy yaml: an entry with
     every key;
  4. its synthetic camera's geometry (the repository's
     test_caddn_harness_render_geometry, on the port's copy).

glenet_tpu marks its own CLI case slow; this one stays small."""
import json
import pickle

import numpy as np
import pytest
import torch

import caddn_parity as cp


@pytest.fixture(scope='module')
def camera_tree(tmp_path_factory):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.utils import synthetic
    base = tmp_path_factory.mktemp('caddn_cli')
    root = synthetic.write_kitti_tree(
        base / 'kitti', n_train=4, n_val=2, seed=3, n_points=6000,
        cars=(2, 3), x_range=(6.0, 14.0), y_half=6.0, ground_radius=20.0,
        camera=True)
    cfg_path = cp.write_toy_caddn_yaml(base / 'toy_caddn.yaml', root)
    cfg = cfg_from_yaml_file(str(cfg_path))
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    synthetic.add_label_variances(root, seed=4)
    return root, cfg_path


def test_train_then_test(camera_tree, tmp_path):
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train
    _, cfg_path = camera_tree
    out = tmp_path / 'out'
    run = train.main(['--cfg_file', str(cfg_path), '--output_dir', str(out),
                      '--epochs', '1', '--max_steps_per_epoch', '2',
                      '--device', 'cpu'])
    assert len(run['steps']) == 2 and len(run['checkpoints']) == 1
    for step in run['steps']:
        assert np.isfinite(step['loss']) and step['loss_depth'] > 0, step
    (res,) = test_cli.main(['--cfg_file', str(cfg_path), '--output_dir',
                            str(out), '--device', 'cpu']).values()
    with open(next((out / 'eval').rglob('result.pkl')), 'rb') as f:
        annos = pickle.load(f)
    assert len(annos) == res['frames'] == 2
    assert 'Car_3d/moderate_R40' in res['ap']


def test_convergence_caddn_runs(camera_tree, tmp_path, monkeypatch):
    """Two harness steps of the toy yaml on the CPU: the entry merged into
    --out holds the AP keys, the loss, the depth accuracy and the device."""
    import tempfile

    from glenet_tpu_torch.tools import convergence_caddn as cc
    _, cfg_path = camera_tree
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    out_file = tmp_path / 'conv.json'
    entry = cc.main(['2', '1e-3', str(cfg_path), '--device', 'cpu',
                     '--out', str(out_file)])
    saved = json.loads(out_file.read_text())['CaDDN']
    assert saved == json.loads(json.dumps(entry))
    for key in ('Car_3d_moderate_R40', 'Car_3d_moderate_R11',
                'Car_bev_moderate_R40', 'final_loss', 'depth_top1',
                'wall_clock_s', 'device'):
        assert key in saved, key
    assert saved['device'] == 'cpu' and np.isfinite(saved['final_loss'])


def test_harness_render_geometry():
    """The harness camera: the z-buffered depth map agrees with the gt
    cars' depths at their projected centres, and the 2-D boxes contain the
    projected centres."""
    from glenet_tpu_torch.tools import convergence_ap as ca
    from glenet_tpu_torch.tools import convergence_caddn as cc
    points, gt, gm = ca.make_scene(3)
    gm = gm & (gt[:, 0] < cc.GT_MAX_X)
    image, depth_ds, boxes2d = cc.render_scene(points, gt, gm)
    assert image.shape == (cc.H, cc.W, 3)
    assert depth_ds.shape == (cc.H // cc.DS, cc.W // cc.DS)
    below = depth_ds[int(cc.CV / cc.DS) + 2:]
    assert (below > 0).mean() > 0.2
    u, v, d = cc.project(gt[gm][:, :3])
    for i, g in enumerate(np.flatnonzero(gm)):
        x0, y0, x1, y1 = boxes2d[g]
        assert x0 <= u[i] <= x1 and y0 <= v[i] <= y1, (i, boxes2d)
        dd = depth_ds[int(v[i] / cc.DS), int(u[i] / cc.DS)]
        if dd > 0:
            assert d[i] - 4.0 < dd < d[i] + 1.0, (dd, d[i])


def test_harness_batches_match_jax_render():
    """The port's rendered harness batches equal glenet_tpu's
    (tools/convergence_caddn.py) on the same scenes."""
    pytest.importorskip('jax')
    import sys
    from pathlib import Path

    from glenet_tpu_torch.tools import convergence_caddn as cc
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / 'tools'))
    import convergence_caddn as jcc

    scenes = cc.make_scenes()[:2]
    got = cc.make_camera_batches(scenes, 'cpu')[0]
    ref = jcc.make_camera_batches([tuple(s) for s in scenes] * 8)[0]
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   rtol=0, atol=0, err_msg=k)
    assert got['images'].dtype == torch.float32
