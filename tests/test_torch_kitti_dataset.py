"""Parity of the port's KITTI host pipeline with glenet_tpu on the mini-KITTI
tree of test_kitti_dataset.py (3 train frames, 1 val frame, 2 cars each):
each package prepares its own copy of the tree, then both load it.

Exact: the infos (key by key, arrays equal), the gt-database files (byte
for byte), training items for two seeds with gt sampling and the three
world augmentations (points, points_mask, gt_boxes, gt_mask,
gt_uncertainty), the order of `iter_batches`, test-split items, and the
port's host library against its numpy versions.  The gt sampler's
collision test is an exact `== 0` on BEV IoU computed in f32 by each
package's own rotated-IoU op; no sampled box of these seeds just touches
another, so no case flips there.  Prediction dicts: atol 1e-5 (the same
numpy arithmetic; only the calibration inverse may round differently)."""
import copy
import pickle
import shutil

import numpy as np
import pytest

pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from test_kitti_dataset import DATASET_CFG, make_kitti_tree  # noqa: E402

ARRAY_KEYS = ('points', 'points_mask', 'gt_boxes', 'gt_mask',
              'gt_uncertainty')


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    """The same tree prepared by glenet_tpu ('jax') and by the port."""
    from glenet_tpu.datasets.kitti_dataset import create_kitti_infos as j_cki

    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    base = tmp_path_factory.mktemp('kitti_parity')
    root = make_kitti_tree(base, np.random.RandomState(7))
    out = {'jax': root, 'port': base / 'kitti_port'}
    shutil.copytree(root, out['port'])
    j_cki(DATASET_CFG, ['Car'], out['jax'], out['jax'])
    create_kitti_infos(tp.to_port_cfg(DATASET_CFG), ['Car'], out['port'],
                       out['port'])
    return out


def _datasets(roots, training, seed=None, cfg=DATASET_CFG):
    from glenet_tpu.datasets.kitti_dataset import KittiDataset as JDataset

    from glenet_tpu_torch.datasets.kitti_dataset import KittiDataset
    return (JDataset(cfg, ['Car'], training=training, root_path=roots['jax'],
                     seed=seed),
            KittiDataset(tp.to_port_cfg(cfg), ['Car'], training=training,
                         root_path=roots['port'], seed=seed))


def _assert_equal_tree(a, b, where=''):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal_tree(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_tree(x, y, f'{where}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b and type(a) is type(b), where


@pytest.mark.parametrize('name', ['kitti_infos_train.pkl',
                                  'kitti_infos_val.pkl',
                                  'kitti_dbinfos_train.pkl'])
def test_infos_equal(roots, name):
    with open(roots['jax'] / name, 'rb') as f:
        ref = pickle.load(f)
    with open(roots['port'] / name, 'rb') as f:
        got = pickle.load(f)
    _assert_equal_tree(ref, got, name)


def test_gt_database_bytes_equal(roots):
    ref = sorted(p.name for p in (roots['jax'] / 'gt_database').iterdir())
    got = sorted(p.name for p in (roots['port'] / 'gt_database').iterdir())
    assert ref == got and len(ref) == 6
    for name in ref:
        assert ((roots['jax'] / 'gt_database' / name).read_bytes()
                == (roots['port'] / 'gt_database' / name).read_bytes()), name


@pytest.mark.parametrize('seed', [0, 5])
def test_train_items_equal(roots, seed):
    """Items 0..3 in turn (index 3 wraps to 0), so the sampler's round-robin
    pointer and permutation and every augmentation draw are exercised."""
    jds, tds = _datasets(roots, True, seed)
    n_sampled = 0
    for i in range(4):
        ref, got = jds[i % len(jds)], tds[i % len(tds)]
        assert ref['frame_id'] == got['frame_id']
        for k in ARRAY_KEYS:
            np.testing.assert_array_equal(ref[k], got[k], err_msg=(i, k))
        n_sampled += int(ref['gt_mask'].sum()) - 2
    assert n_sampled > 0, 'gt sampling added no box'


def test_iter_batches_order(roots):
    jds, tds = _datasets(roots, True, 3)
    for epoch in (0, 1):
        for ref, got in zip(jds.iter_batches(2, seed=epoch),
                            tds.iter_batches(2, seed=epoch)):
            assert ref['frame_id'] == got['frame_id']
            for k in ARRAY_KEYS:
                np.testing.assert_array_equal(ref[k], got[k])


def test_test_split_items(roots):
    jds, tds = _datasets(roots, False)
    assert len(jds) == len(tds) == 1
    (ref,), (got,) = (list(ds.iter_batches(2, shuffle=False, drop_last=False))
                      for ds in (jds, tds))
    assert ref['frame_id'] == got['frame_id']
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(ref[k], got[k])


def test_generate_prediction_dicts(roots, tmp_path):
    jds, tds = _datasets(roots, False)
    rng = np.random.RandomState(2)
    k = 6
    boxes = np.zeros((2, k, 7), np.float32)
    boxes[..., 0] = rng.uniform(5, 40, (2, k))
    boxes[..., 1] = rng.uniform(-10, 10, (2, k))
    boxes[..., 2] = rng.uniform(-1.5, -0.5, (2, k))
    boxes[..., 3:6] = [3.9, 1.6, 1.56]
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (2, k))
    valid = rng.uniform(0, 1, (2, k)) < 0.7
    valid[1] = False                                   # an empty frame
    preds = {'final_boxes': boxes, 'final_scores': rng.uniform(0, 1, (2, k)),
             'final_labels': np.ones((2, k), np.int64),
             'final_valid': valid}
    batch = next(jds.iter_batches(2, shuffle=False, drop_last=False))
    batch['frame_id'] = [batch['frame_id'][0], 'empty']
    ref = jds.generate_prediction_dicts(batch, preds)
    out_dir = tmp_path / 'txt'
    out_dir.mkdir()
    got = tds.generate_prediction_dicts(
        batch, {k: torch.from_numpy(np.asarray(v)) for k, v in preds.items()},
        output_path=out_dir)
    for r, g in zip(ref, got):
        assert set(r) == set(g)
        for key in r:
            if key in ('name', 'frame_id'):
                assert np.array_equal(r[key], g[key])
            else:
                np.testing.assert_allclose(g[key], r[key], atol=1e-5,
                                           err_msg=key)
    lines = (out_dir / f"{batch['frame_id'][0]}.txt").read_text().splitlines()
    assert len(lines) == int(valid[0].sum())
    assert (out_dir / 'empty.txt').read_text() == ''


def test_host_library_equals_numpy(roots):
    from glenet_tpu_torch.ops import host_ops
    with open(roots['port'] / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    boxes = np.concatenate([i['annos']['gt_boxes_lidar'] for i in infos])
    for info in infos:
        pts = np.fromfile(str(roots['port'] / 'training/velodyne' /
                              f"{info['point_cloud']['lidar_idx']}.bin"),
                          np.float32).reshape(-1, 4)
        got = host_ops.points_in_rboxes(pts, boxes)
        assert got.any()
        np.testing.assert_array_equal(
            got, host_ops.points_in_rboxes_plain(pts, boxes))
    # collisions among many boxes of a dense synthetic tree, touching ones
    # included
    rng = np.random.RandomState(0)
    many = np.concatenate([boxes, boxes + rng.uniform(-2, 2, boxes.shape)
                           * [1, 1, 0, 0, 0, 0, 1]]).astype(np.float32)
    got = host_ops.rbox_collision(many, many)
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got, host_ops.rbox_collision_plain(many,
                                                                     many))
    assert host_ops.points_in_rboxes(np.zeros((0, 3)), boxes).shape == (
        0, len(boxes))


def test_build_dataset(roots):
    from glenet_tpu_torch.datasets import build_dataset
    cfg = tp.to_port_cfg(copy.deepcopy(DATASET_CFG))
    cfg.DATA_PATH = str(roots['port'])
    ds = build_dataset(cfg, ['Car'], training=False)
    assert type(ds).__name__ == 'KittiDataset' and len(ds) == 1
