"""Traffic from the seed, and the tail over all requests."""
import numpy as np

from benchmark import frames
from benchmark.drivers import predict
from benchmark.tests import tiny


def _pool(seed):
    return frames.make_pool(tiny.session('waymo_glenet_s.train_b4').traffic,
                            seed)


def test_same_seed_same_traffic():
    a, b = _pool(2 ** 31 + 3), _pool(2 ** 31 + 3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_seeds_share_the_load():
    a, c = _pool(1), _pool(2)
    assert not np.array_equal(a['points'], c['points'])
    assert sorted(a['gt_mask'].sum(-1).ravel()) == sorted(
        c['gt_mask'].sum(-1).ravel())


def test_vehicle_counts_mean():
    counts = frames.vehicle_counts(64, 1, 52)
    assert counts.min() == 1 and counts.max() == 52
    assert abs(counts.mean() - 26.5) < 0.1


def test_p95_over_all_requests():
    lat = list(np.arange(1, 201, dtype=float))
    assert predict.p95(lat) == np.percentile(lat, 95)
    lat[-1] = 1e6                   # one slow request moves no p95 of 200
    assert predict.p95(lat) == np.percentile(lat, 95)


def test_checked_sample_has_the_slowest():
    window = [(i, float(i % 7), None) for i in range(50)]
    s = predict.checked_sample(window, 5, 6)
    assert len(set(s)) == 6 and window[s[0]][1] == 6.0
    assert s == predict.checked_sample(window, 5, 6)
