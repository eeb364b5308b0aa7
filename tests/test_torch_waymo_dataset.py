"""Parity of the port's Waymo adapter (glenet_tpu_torch/datasets/
waymo_dataset.py, waymo_utils.py) with glenet_tpu's on a synthetic tree in
Waymo's processed layout (utils/synthetic.write_waymo_tree: 2% of the
points in a no-label zone, label variances in the infos): the infos and
SAMPLED_INTERVAL; training items for 2 seeds with waymo_dataset.yaml's
augmentations (gt sampling from the gt database, world flip / rotation /
scaling) equal field by field; the gt database's crops byte for byte and
its dbinfos; prediction dicts; and the KITTI-format round trip with its
evaluation.  Integers and floats exactly, AP within 1e-3."""
import pickle
import shutil

import numpy as np
import pytest
import yaml

pytest.importorskip('jax')

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cfg(root, augment):
    with open(ROOT / 'configs/dataset_configs/waymo_dataset.yaml') as f:
        data = yaml.safe_load(f)
    data.update(DATA_PATH=str(root), MAX_POINTS_PER_SCENE=8192,
                MAX_GT_PER_SCENE=32, SAMPLED_INTERVAL={'train': 2,
                                                       'test': 1})
    data['DATA_AUGMENTOR']['AUG_CONFIG_LIST'][0]['SAMPLE_GROUPS'] = [
        'Vehicle:12']
    if not augment:
        del data['DATA_AUGMENTOR']
    return data


def _pair(data):
    from glenet_tpu.config import Cfg as JCfg

    from glenet_tpu_torch.config import Cfg
    return JCfg(data), Cfg(data)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """The tree and its gt database (written by the port, with label
    variances)."""
    from glenet_tpu_torch.datasets.waymo_dataset import \
        create_waymo_gt_database
    from glenet_tpu_torch.utils import synthetic
    root = synthetic.write_waymo_tree(
        tmp_path_factory.mktemp('waymo') / 'waymo', n_seq=3,
        frames_per_seq=4, seed=2, n_points=6000, vehicles=(4, 8))
    _, cfg = _pair(_cfg(root, False))
    create_waymo_gt_database(cfg, ['Vehicle'], root)
    synthetic.add_waymo_db_variances(root)
    return root


def _datasets(root, augment, training=True, seed=None):
    from glenet_tpu.datasets.waymo_dataset import WaymoDataset as JDs

    from glenet_tpu_torch.datasets.waymo_dataset import WaymoDataset
    jc, tc = _pair(_cfg(root, augment))
    names = ['Vehicle', 'Pedestrian']
    return (JDs(jc, names, training=training, seed=seed),
            WaymoDataset(tc, names, training=training, seed=seed))


def test_infos_and_interval(tree):
    jds, tds = _datasets(tree, False)
    # 2 train sequences x 4 frames, every second frame
    assert len(tds) == len(jds) == 4
    assert [i['frame_id'] for i in tds.infos] == \
        [i['frame_id'] for i in jds.infos]
    jv, tv = _datasets(tree, False, training=False)
    assert len(tv) == len(jv) == 4


def _assert_items_equal(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize('seed', [0, 1])
def test_training_items(tree, seed):
    """Batches of the training order of `seed`: gt sampling, world
    augmentations, class filter, NLZ points, shuffle and padding."""
    jds, tds = _datasets(tree, True, seed=seed)
    n_sampled = 0
    for ref, got in zip(jds.iter_batches(2, seed=seed),
                        tds.iter_batches(2, seed=seed)):
        _assert_items_equal(got, ref)
        n_sampled += int(ref['gt_mask'].sum())
    assert n_sampled > 4 * 8, 'gt sampling added no box'
    item = tds[1]
    assert item['points'].shape == (8192, 5)
    cls = item['gt_boxes'][item['gt_mask'], 7]
    assert set(cls) <= {1, 2} and (cls == 1).sum() > 8
    assert (item['gt_uncertainty'][item['gt_mask']][cls == 1] > 0).all()


def test_gt_database_equal(tree, tmp_path):
    """The crops and dbinfos of both packages' create_groundtruth_database
    on copies of the tree."""
    from glenet_tpu.datasets.waymo_dataset import WaymoDataset as JDs

    from glenet_tpu_torch.datasets.waymo_dataset import WaymoDataset
    dbs = {}
    for name, cls in (('jax', JDs), ('port', WaymoDataset)):
        root = tmp_path / name
        shutil.copytree(tree, root, ignore=shutil.ignore_patterns(
            'pcdet_*'))
        jc, tc = _pair(_cfg(root, False))
        ds = cls(jc if name == 'jax' else tc, ['Vehicle'], training=False)
        dbs[name] = (root, ds.create_groundtruth_database(['Vehicle']))
    (jroot, jdb), (troot, tdb) = dbs['jax'], dbs['port']
    assert list(tdb) == list(jdb)
    for cls in jdb:
        assert len(tdb[cls]) == len(jdb[cls]) > 0
        for a, b in zip(tdb[cls], jdb[cls]):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert (troot / a['path']).read_bytes() == \
                (jroot / b['path']).read_bytes()
    with open(troot / 'pcdet_waymo_dbinfos_val.pkl', 'rb') as f:
        assert len(pickle.load(f)['Vehicle']) == len(tdb['Vehicle'])


def test_prediction_dicts(tree):
    import torch
    jds, tds = _datasets(tree, False, training=False)
    rng = np.random.RandomState(0)
    preds = {'final_boxes': rng.randn(2, 5, 7).astype(np.float32),
             'final_scores': rng.rand(2, 5).astype(np.float32),
             'final_labels': rng.randint(1, 3, (2, 5)).astype(np.int64),
             'final_valid': rng.rand(2, 5) > 0.3}
    batch = {'frame_id': ['a', 'b']}
    ref = jds.generate_prediction_dicts(batch, preds)
    got = tds.generate_prediction_dicts(
        batch, {k: torch.from_numpy(v) for k, v in preds.items()})
    for a, b in zip(got, ref):
        _assert_items_equal(a, b)


def test_kitti_format_round_trip(tree):
    """transform_annos_to_kitti_format equal, and the KITTI-format
    evaluation of jittered gts (the eval_metric='kitti' fallback) within
    1e-3 of glenet_tpu's."""
    from glenet_tpu.datasets import waymo_utils as jwu

    from glenet_tpu_torch.datasets import waymo_utils
    jds, tds = _datasets(tree, False, training=False)
    rng = np.random.RandomState(1)
    dets = []
    for info in tds.infos:
        a = info['annos']
        keep = a['name'] == 'Vehicle'
        boxes = a['gt_boxes_lidar'][keep].copy()
        boxes[:, :2] += rng.normal(0, 0.2, (len(boxes), 2))
        dets.append({'name': a['name'][keep], 'boxes_lidar': boxes,
                     'score': rng.rand(len(boxes)),
                     'frame_id': info['frame_id']})
        for anno in (dict(a), dets[-1]):
            _assert_items_equal(
                waymo_utils.transform_annos_to_kitti_format(anno, True),
                jwu.transform_annos_to_kitti_format(anno, True))
    _, ref = jds.evaluation(dets, ['Vehicle'], eval_metric='kitti')
    _, got = tds.evaluation(dets, ['Vehicle'], eval_metric='kitti',
                            device='cpu')
    assert set(got) == set(ref) and 'Car_3d/moderate_R40' in got
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-3, k
    assert got['Car_3d/moderate_R40'] > 0
    _, ref = jds.evaluation(dets, ['Vehicle'])
    _, got = tds.evaluation(dets, ['Vehicle'], device='cpu')
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-3, k
