"""Parity of the port's raw Waymo extraction (glenet_tpu_torch/datasets/
waymo_raw.py) with glenet_tpu/datasets/waymo_raw.py, with the fake SDK of
tests/test_waymo_raw.py (its frames and point extractor injected through
the seams): the sequence pkl equal field by field and every npy equal byte
for byte, the SAMPLED_INTERVAL subsampling, the skip of an extracted
sequence, the schema validator, and the port's WaymoDataset reading the
extracted layout."""
import pickle

import numpy as np
import pytest

pytest.importorskip('jax')

from test_waymo_raw import fake_extract_points, make_fake_frame  # noqa: E402


def _frames(n):
    return [make_fake_frame(s, n_labels=3 + s % 2) for s in range(n)]


def _equal(a, b, where='info'):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), where
        for k in b:
            _equal(a[k], b[k], f'{where}/{k}')
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f'{where}[{i}]')
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize('interval', [1, 2])
def test_extraction_equals_glenet_tpu(tmp_path, interval):
    from glenet_tpu.datasets import waymo_raw as jraw

    from glenet_tpu_torch.datasets import waymo_raw
    out = {}
    for name, mod in (('jax', jraw), ('port', waymo_raw)):
        out[name] = mod.process_single_sequence(
            tmp_path / 'segment-001.tfrecord', tmp_path / name,
            sampled_interval=interval, frame_iter=iter(_frames(6)),
            point_extractor=fake_extract_points)
    _equal(out['port'], out['jax'])
    assert [i['point_cloud']['sample_idx'] for i in out['port']] == \
        list(range(0, 6, interval))
    seq = 'segment-001'
    files = sorted(p.name for p in (tmp_path / 'jax' / seq).iterdir())
    assert files == sorted(p.name for p in (tmp_path / 'port' / seq)
                           .iterdir())
    for f in files:
        a = (tmp_path / 'port' / seq / f).read_bytes()
        b = (tmp_path / 'jax' / seq / f).read_bytes()
        if f.endswith('.npy'):
            assert a == b, f
        else:
            _equal(pickle.loads(a), pickle.loads(b))
    infos = waymo_raw.validate_sequence_dir(tmp_path / 'port' / seq)
    assert len(infos) == len(out['port'])


def test_generate_labels_equal():
    from glenet_tpu.datasets import waymo_raw as jraw

    from glenet_tpu_torch.datasets import waymo_raw
    frame = make_fake_frame(7, n_labels=8)
    got, ref = waymo_raw.generate_labels(frame), jraw.generate_labels(frame)
    _equal(got, ref)
    assert len(got['name']) == 6


def test_reextraction_skips_and_validator(tmp_path):
    from glenet_tpu_torch.datasets import waymo_raw
    first = waymo_raw.process_single_sequence(
        tmp_path / 'segment-001.tfrecord', tmp_path / 'p',
        frame_iter=iter(_frames(4)), point_extractor=fake_extract_points)
    again = waymo_raw.process_single_sequence(
        tmp_path / 'segment-001.tfrecord', tmp_path / 'p')
    assert [i['frame_id'] for i in again] == [i['frame_id'] for i in first]
    seq_dir = tmp_path / 'p' / 'segment-001'
    np.save(str(seq_dir / '0001.npy'), np.zeros((10, 4), np.float32))
    with pytest.raises(AssertionError, match='x y z i e nlz'):
        waymo_raw.validate_sequence_dir(seq_dir)


def test_waymo_dataset_reads_extraction(tmp_path):
    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.datasets.waymo_dataset import WaymoDataset
    from glenet_tpu_torch.datasets import waymo_raw
    waymo_raw.process_single_sequence(
        tmp_path / 'segment-001.tfrecord', tmp_path / 'processed',
        frame_iter=iter(_frames(4)), point_extractor=fake_extract_points)
    (tmp_path / 'ImageSets').mkdir()
    (tmp_path / 'ImageSets' / 'val.txt').write_text('segment-001.tfrecord\n')
    cfg = Cfg({
        'PROCESSED_DATA_TAG': 'processed',
        'DATA_SPLIT': {'train': 'train', 'test': 'val'},
        'POINT_CLOUD_RANGE': [-75.2, -75.2, -2, 75.2, 75.2, 4],
        'MAX_POINTS_PER_SCENE': 2000, 'MAX_GT_PER_SCENE': 16,
        'SAMPLED_INTERVAL': {'train': 1, 'test': 1},
        'POINT_FEATURE_ENCODING': {
            'used_feature_list': ['x', 'y', 'z', 'intensity', 'elongation'],
            'src_feature_list': ['x', 'y', 'z', 'intensity', 'elongation']},
        'DATA_PROCESSOR': []})
    ds = WaymoDataset(cfg, ['Vehicle', 'Pedestrian', 'Cyclist'],
                      training=False, root_path=tmp_path)
    assert len(ds) == 4
    item = ds[0]
    assert item['points'].shape == (2000, 5)
    assert item['gt_boxes'].shape == (16, 8)
