"""Parity of the port's CVAE crop datasets (glenet_tpu_torch/cvae/dataset.py)
with glenet_tpu/cvae/dataset.py on synthetic gt databases
(utils/synthetic.write_crop_database): the same seeded RandomState in both
datasets gives exactly equal items, occlusion (both branches), flip,
scale, rotation and the Waymo azimuth canonicalisation included; the
port's K-fold split equals scikit-learn's KFold, which the JAX package
calls."""
import numpy as np
import pytest

pytest.importorskip('jax')
sk = pytest.importorskip('sklearn.model_selection')

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _data_cfg(name, **extra):
    """DATA_CONFIG of a CVAE config as both packages' Cfg."""
    from glenet_tpu.config import Cfg as JCfg
    from glenet_tpu_torch.config import Cfg, cfg_from_yaml_file
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/cvae' / name))
    data = dict(cfg.DATA_CONFIG, **extra)
    return JCfg(dict(data)), Cfg(dict(data))


@pytest.fixture(scope='module')
def kitti_db(tmp_path_factory):
    from glenet_tpu_torch.utils.synthetic import write_crop_database
    root = tmp_path_factory.mktemp('kitti_crops')
    write_crop_database(root, 60, 8, seed=1)
    return root


@pytest.fixture(scope='module')
def waymo_db(tmp_path_factory):
    from glenet_tpu_torch.utils.synthetic import write_crop_database
    root = tmp_path_factory.mktemp('waymo_crops')
    write_crop_database(root, 40, seed=2, waymo=True)
    return root


def _pair(kind, root, training, **extra):
    from glenet_tpu.cvae import dataset as jds
    from glenet_tpu_torch.cvae import dataset as tds
    name = 'exp_gen.yaml' if kind == 'kitti' else 'waymo_exp_gen.yaml'
    jcfg, tcfg = _data_cfg(name, **extra)
    cls = 'KittiGtDataset' if kind == 'kitti' else 'WaymoGtDataset'
    return (getattr(jds, cls)(jcfg, training=training, root_path=root),
            getattr(tds, cls)(tcfg, training=training, root_path=root))


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _record_occlusion(ds, log):
    """Wrap ds.occlude_aug to log (max_try_time, points in, points out)."""
    real = ds.occlude_aug

    def occlude(info, points, **kw):
        out = real(info, points, **kw)
        log.append((kw['max_try_time'], len(points), len(out)))
        return out

    ds.occlude_aug = occlude


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('kind,fold', [('kitti', 0), ('kitti', 2),
                                       ('waymo', 1)])
def test_train_items_equal(kind, fold, seed, kitti_db, waymo_db):
    """Training items of one fold (FORCE_RATIO 0.8 at linear_anneal 0.6:
    the forced occlusion with 20 tries and the plain one with 5 both
    run), equal element for element and in dtype."""
    root = kitti_db if kind == 'kitti' else waymo_db
    jd, td = _pair(kind, root, True, FOLD_IDX=fold, NUM_FOLDS=4,
                   FORCE_RATIO=0.8)
    assert [i['path'] for i in jd.infos] == [i['path'] for i in td.infos]
    assert len(td.dense_gt_infos) > 0
    log = []
    _record_occlusion(td, log)
    for ds in (jd, td):
        ds.linear_anneal = 0.6
        ds.rng = np.random.RandomState(seed)
    for i in range(len(td)):
        _assert_items_equal(jd[i], td[i])
    tries = {t for t, _, _ in log}
    assert tries == {5, 20}, tries
    assert any(n_out < n_in for _, n_in, n_out in log)


@pytest.mark.parametrize('kind', ['kitti', 'waymo'])
def test_val_items_and_batches_equal(kind, kitti_db, waymo_db):
    """Val items (no augmentation, the resampling draws only) and the
    collated batches of iter_batches, shuffled and in order."""
    root = kitti_db if kind == 'kitti' else waymo_db
    jd, td = _pair(kind, root, False, FOLD_IDX=1, NUM_FOLDS=3)
    for ds in (jd, td):
        ds.rng = np.random.RandomState(4)
    for shuffle, drop_last in ((True, True), (False, False)):
        jb = list(jd.iter_batches(8, shuffle=shuffle, seed=3,
                                  drop_last=drop_last))
        tb = list(td.iter_batches(8, shuffle=shuffle, seed=3,
                                  drop_last=drop_last))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            _assert_items_equal(a, b)


def test_item_geometry(kitti_db):
    """A val item: 512 points, the 8-dim box input holds (sin, cos) of the
    heading, and denormalize_box recovers the crop's box size."""
    from glenet_tpu_torch.cvae import dataset as tds
    _, tcfg = _data_cfg('exp_gen.yaml')
    ds = tds.KittiGtDataset(tcfg, training=False, root_path=kitti_db)
    item = ds[0]
    assert item['points'].shape == (512, 4)
    np.testing.assert_allclose(item['gt_boxes_input'][6:],
                               [np.sin(item['gt_boxes'][6]),
                                np.cos(item['gt_boxes'][6])], atol=1e-6)
    np.testing.assert_allclose(tds.denormalize_box(item['gt_boxes'])[3:6],
                               ds.infos[0]['box3d_lidar'][3:6], rtol=1e-5)


@pytest.mark.parametrize('anchor', ['kitti', 'waymo'])
def test_denormalize_box(anchor):
    from glenet_tpu.cvae import dataset as jds
    from glenet_tpu_torch.cvae import dataset as tds
    boxes = np.random.RandomState(0).randn(5, 3, 7).astype(np.float32)
    a = (jds.ANCHOR, tds.ANCHOR) if anchor == 'kitti' else (
        jds.WAYMO_ANCHOR, tds.WAYMO_ANCHOR)
    assert a[0] == a[1]
    np.testing.assert_array_equal(jds.denormalize_box(boxes, a[0]),
                                  tds.denormalize_box(boxes, a[1]))


@pytest.mark.parametrize('n', [24, 25, 15654])
@pytest.mark.parametrize('k', [3, 5, 10])
def test_kfold_equals_sklearn(n, k):
    """Every fold of the port's split equals KFold(shuffle=True,
    random_state=42), both index lists in ascending order."""
    from glenet_tpu_torch.cvae.dataset import kfold_split
    splits = list(sk.KFold(n_splits=k, shuffle=True,
                           random_state=42).split(np.arange(n)))
    for fold, (train_idx, val_idx) in enumerate(splits):
        got_train, got_val = kfold_split(n, k, fold)
        np.testing.assert_array_equal(got_train, train_idx)
        np.testing.assert_array_equal(got_val, val_idx)


def test_kfold_refuses_too_few_items():
    from glenet_tpu_torch.cvae.dataset import kfold_split
    with pytest.raises(ValueError):
        kfold_split(4, 5, 0)


def test_crop_database_layout(kitti_db):
    """write_crop_database writes what create_groundtruth_database writes
    and what the occlusion reads: crops relative to their box, the db keys,
    calib and plane files per frame, dense donors."""
    import pickle
    with open(kitti_db / 'kitti_dbinfos_train.pkl', 'rb') as f:
        db = pickle.load(f)
    assert {len(db['Car']), len(db['Van'])} == {60, 8}
    infos = db['Car'] + db['Van']
    assert {frozenset(i) for i in infos} == {frozenset(
        ('path', 'image_idx', 'gt_idx', 'box3d_lidar', 'num_points_in_gt',
         'name'))}
    for info in infos:
        pts = np.fromfile(str(kitti_db / info['path']),
                          np.float32).reshape(-1, 4)
        assert len(pts) == info['num_points_in_gt']
        half = np.linalg.norm(info['box3d_lidar'][3:6]) / 2
        assert (np.linalg.norm(pts[:, :3], axis=1) <= half + 1e-4).all()
        for sub in ('calib', 'planes'):
            assert (kitti_db / 'training' / sub
                    / f"{info['image_idx']}.txt").exists()
    assert sum(i['num_points_in_gt'] > 1000 for i in infos) >= 2
