"""Parity of the port's nuScenes pieces (glenet_tpu_torch/datasets/
{nuscenes_raw, nuscenes_dataset}.py) with glenet_tpu's, on the CPU:

  - the info-building geometry on seeded random records (quaternions,
    transforms, yaws, boxes from the global frame into the sensor's, the
    sweep chain, the info of a sample), atol 1e-6 (the same numpy in
    float64: equal in practice);
  - the devkit seams raise the same RuntimeError without the devkit;
  - the adapters over one synthetic tree (utils/synthetic.
    write_nuscenes_tree, nuscenes_parity.nusc_tree) with both datasets'
    RandomStates set to one seeded state: training items (sweeps drawn
    without replacement, gt sampling from the tree's database, world
    flip / rotation / scaling, shuffle, padding) and test items, batch by
    batch, integers and masks exactly and floats bit for bit;
  - prediction dicts, and the NDS dict of both packages on the same
    detections (each gt moved by up to 1.5 m, resized and turned, with
    false positives) to 1e-6."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

from glenet_tpu.datasets import nuscenes_raw as jnr  # noqa: E402

import nuscenes_parity as npar  # noqa: E402
from glenet_tpu_torch.datasets import nuscenes_raw as tnr  # noqa: E402

NAME = 'nuscenes_centerpoint'


def _quat(rng):
    q = rng.randn(4)
    return tuple(q / np.linalg.norm(q))


def _record(rng):
    return {'translation': list(rng.uniform(-20, 20, 3)),
            'rotation': _quat(rng)}


@pytest.mark.parametrize('seed', [0, 1])
def test_geometry(seed):
    rng = np.random.RandomState(seed)
    q, t = _quat(rng), rng.uniform(-50, 50, 3)
    np.testing.assert_allclose(tnr.quat_to_rot(q), jnr.quat_to_rot(q),
                               rtol=0, atol=1e-6)
    for inverse in (False, True):
        np.testing.assert_allclose(tnr.transform_matrix(t, q, inverse),
                                   jnr.transform_matrix(t, q, inverse),
                                   rtol=0, atol=1e-6)
    assert abs(tnr.quaternion_yaw(q) - jnr.quaternion_yaw(q)) <= 1e-6
    n = 12
    args = (rng.uniform(-60, 60, (n, 3)), rng.uniform(0.5, 5, (n, 3)),
            [_quat(rng) for _ in range(n)], rng.uniform(-10, 10, (n, 3)),
            _record(rng), _record(rng))
    for got, ref in zip(tnr.boxes_global_to_sensor(*args),
                        jnr.boxes_global_to_sensor(*args)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _world(rng, n_hist):
    """A LIDAR_TOP sample_data chain of random poses and calibrations."""
    records = {'sample_data': {}, 'ego_pose': {}, 'calibrated_sensor': {}}
    prev = ''
    for i in range(n_hist + 1):
        records['ego_pose'][f'p{i}'] = _record(rng)
        records['calibrated_sensor'][f'c{i}'] = _record(rng)
        records['sample_data'][f'sd{i}'] = {
            'token': f'sd{i}', 'prev': prev,
            'timestamp': 1_000_000 + i * 50_000 + rng.randint(100),
            'ego_pose_token': f'p{i}', 'calibrated_sensor_token': f'c{i}'}
        prev = f'sd{i}'
    return records, lambda table, token: records[table][token]


def _assert_tree_equal(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _assert_tree_equal(got[k], ref[k])
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_tree_equal(g, r)
    elif isinstance(ref, np.ndarray) and ref.dtype.kind == 'f':
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref)
    elif isinstance(ref, float):
        assert got == pytest.approx(ref, abs=1e-6)
    else:
        assert got == ref


@pytest.mark.parametrize('n_hist,max_sweeps', [(5, 4), (1, 10)])
def test_sweeps_and_info(n_hist, max_sweeps):
    """chain_sweeps (the chain longer and shorter than max_sweeps) and
    build_sample_info with the box and camera seams mocked."""
    rng = np.random.RandomState(n_hist)
    records, get = _world(rng, n_hist)
    ref_sd = records['sample_data'][f'sd{n_hist}']
    cs = records['calibrated_sensor'][f'c{n_hist}']
    pose = records['ego_pose'][f'p{n_hist}']
    args = (get, ref_sd, cs, pose, '/data', lambda t: f'/data/s/{t}.bin',
            max_sweeps)
    _assert_tree_equal(tnr.chain_sweeps(*args), jnr.chain_sweeps(*args))
    n = 5
    boxes = (rng.uniform(-40, 40, (n, 3)), rng.uniform(0.5, 5, (n, 3)),
             [_quat(rng) for _ in range(n)], rng.uniform(-5, 5, (n, 3)),
             ['vehicle.car', 'human.pedestrian.adult', 'animal',
              'vehicle.bus.rigid', 'movable_object.barrier'],
             [f'a{i}' for i in range(n)], [3, 0, 7, 0, 2], [0, 0, 1, 0, 0])
    sample = {'token': 's0', 'data': {'LIDAR_TOP': f'sd{n_hist}'}}
    kw = dict(box_fn=lambda s: boxes,
              cam_fn=lambda s: ('/data/cam.jpg', np.eye(3) * 2))
    got = tnr.build_sample_info(get, sample, '/data',
                                lambda t: f'/data/s/{t}.bin', max_sweeps,
                                **kw)
    ref = jnr.build_sample_info(get, sample, '/data',
                                lambda t: f'/data/s/{t}.bin', max_sweeps,
                                **kw)
    _assert_tree_equal(got, ref)
    assert list(got['gt_names']) == ['car', 'ignore', 'barrier']


@pytest.mark.parametrize('seam', ['create_nuscenes_info',
                                  'create_lyft_info'])
def test_devkit_seams_raise(seam, tmp_path):
    args = (('v1.0-mini', tmp_path, tmp_path) if seam == 'create_nuscenes_info'
            else ('trainval', tmp_path, tmp_path, {}))
    with pytest.raises(RuntimeError) as ref:
        getattr(jnr, seam)(*args)
    with pytest.raises(RuntimeError) as got:
        getattr(tnr, seam)(*args)
    assert str(got.value) == str(ref.value)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return npar.nusc_tree(tmp_path_factory.mktemp('nusc') / 'nuscenes')


def _class_names():
    from glenet_tpu_torch.utils.synthetic import NUSC_CLASSES
    return list(NUSC_CLASSES)


def _assert_items_equal(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize('training', [True, False])
def test_items(tree, training):
    jds, tds = npar.dataset_pair(npar.data_dict(NAME, tree), _class_names(),
                                 training)
    assert type(tds).__name__ == 'NuScenesDataset' and tds.METRIC == \
        'nuScenes'
    assert len(tds) == len(jds) == (4 if training else 3)
    n_gt = n_pts = 0
    for ref, got in zip(jds.iter_batches(2, seed=3),
                        tds.iter_batches(2, seed=3)):
        _assert_items_equal(got, ref)
        n_gt += int(ref['gt_mask'].sum())
        n_pts += int(ref['points_mask'].sum())
    assert n_gt > 8 and n_pts > 2 * 4096 * 0.9
    # the time lags of the 9 drawn sweeps
    lags = np.unique(ref['points'][ref['points_mask']][:, 4])
    assert len(lags) == 10 and lags[0] == 0.0


def _detections(gt_annos, seed):
    """Per frame each gt moved by up to 1.5 m in x and y, resized by up to
    20% and turned by up to 0.5 rad, scores in (0.2, 1), and 2 false
    positives of the first class; numpy only."""
    rng = np.random.RandomState(seed)
    dets = []
    for gt in gt_annos:
        b = np.asarray(gt['boxes_lidar'])[:, :7].astype(np.float32)
        b[:, :2] += rng.uniform(-1.5, 1.5, (len(b), 2))
        b[:, 3:6] *= rng.uniform(0.8, 1.2, (len(b), 3))
        b[:, 6] += rng.uniform(-0.5, 0.5, len(b))
        fp = np.tile(b[:1], (2, 1))
        fp[:, :2] += 30.0
        names = np.concatenate([gt['name'], np.array(['car', 'car'])])
        dets.append({'name': names, 'boxes_lidar': np.concatenate([b, fp]),
                     'score': rng.uniform(0.2, 1.0, len(names)).astype(
                         np.float32)})
    return dets


def test_evaluation(tree):
    """The NDS dict: per class AP at each distance and its mean, mAP,
    mATE / mASE / mAOE and NDS, equal within 1e-6."""
    jds, tds = npar.dataset_pair(npar.data_dict(NAME, tree), _class_names(),
                                 training=False)
    dets = _detections(tds.gt_annos(), 4)
    names = _class_names()
    _, ref = jds.evaluation(dets, names)
    _, got = tds.evaluation(dets, names, device='cpu')
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert 0 < got['NDS'] < 100 and got['car_AP_4.0'] > got['car_AP_0.5']


def test_prediction_dicts(tree):
    from glenet_tpu_torch.datasets import build_dataset
    from glenet_tpu_torch.config import Cfg
    names = _class_names()
    ds = build_dataset(Cfg(npar.data_dict(NAME, tree)), names,
                       training=False)
    rng = np.random.RandomState(0)
    preds = {'final_boxes': torch.from_numpy(rng.randn(2, 5, 7).astype(
                 np.float32)),
             'final_scores': torch.rand(2, 5),
             'final_labels': torch.randint(1, 11, (2, 5)),
             'final_valid': torch.from_numpy(rng.rand(2, 5) > 0.4)}
    batch = {'frame_id': ['a', 'b']}
    annos = ds.generate_prediction_dicts(batch, preds)
    for b, a in enumerate(annos):
        v = preds['final_valid'][b].numpy()
        assert a['frame_id'] == batch['frame_id'][b]
        assert list(a['name']) == [names[int(i) - 1] for i in
                                   preds['final_labels'][b][v]]
        np.testing.assert_array_equal(a['boxes_lidar'],
                                      preds['final_boxes'][b][v].numpy())
