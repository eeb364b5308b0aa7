"""Parity of the port's Waymo evaluation (glenet_tpu_torch/eval/
waymo_eval.py) with glenet_tpu/eval/waymo_eval.py on the CPU: AP / APH at
LEVEL_1 / LEVEL_2 within 1e-3 (percent) and the same ret_dict keys, on
random frames of three classes where some frames take the Hungarian
matching and others the greedy fallback (HUNGARIAN_BUDGET lowered in both
packages), and the hand-built and random cases of
tests/test_waymo_eval_oracle.py against its naive transcription of the
protocol.  The port computes the 3D IoUs with its own ops/iou3d.py (the
same f32 arithmetic as glenet_tpu's), in one batch over the frames."""
import numpy as np
import pytest

pytest.importorskip('jax')

from test_waymo_eval_oracle import (naive_evaluate_class,  # noqa: E402
                                    random_scenario)

CLASSES = ['Vehicle', 'Pedestrian', 'Cyclist']


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_matches_glenet_tpu(seed, monkeypatch):
    from glenet_tpu.eval import waymo_eval as jwe

    from glenet_tpu_torch.eval import waymo_eval as twe
    for mod in (jwe, twe):
        monkeypatch.setattr(mod, 'HUNGARIAN_BUDGET', 12)
    rng = np.random.RandomState(seed)
    dets, gts = random_scenario(rng, n_frames=12, max_gt=8, max_det=12)
    sizes = [(int(np.sum(d['name'] == c)), int(np.sum(g['name'] == c)))
             for d, g in zip(dets, gts) for c in CLASSES]
    pairs = [nd * ng for nd, ng in sizes if nd and ng]
    assert min(pairs) <= 12 < max(pairs), 'both matchers must be hit'
    ref_str, ref = jwe.waymo_evaluation(dets, gts, CLASSES + ['Sign'])
    got_str, got = twe.waymo_evaluation(dets, gts, CLASSES + ['Sign'],
                                        device='cpu')
    assert list(got) == list(ref) and len(got) == 12
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-3, (k, got[k], v)
    assert got_str.splitlines()[0].split(':')[0] == \
        ref_str.splitlines()[0].split(':')[0]


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_matches_naive_transcription_random(seed):
    from glenet_tpu_torch.eval import waymo_eval
    rng = np.random.RandomState(seed)
    det_annos, gt_annos = random_scenario(rng)
    for cls in CLASSES:
        for level in (1, 2):
            want = naive_evaluate_class(det_annos, gt_annos, cls, level)
            got = waymo_eval.evaluate_class_level(det_annos, gt_annos, cls,
                                                  level, device='cpu')
            np.testing.assert_allclose(got, want, atol=1e-3,
                                       err_msg=f'{cls} L{level} {seed}')


def test_ignored_overlap_and_heading_flip():
    """A det matched to a difficulty-2 gt is ignored at LEVEL_1; a heading
    flipped by pi keeps AP 100 and gives APH 0."""
    from glenet_tpu_torch.eval import waymo_eval
    gt = {'name': np.array(['Vehicle', 'Vehicle']),
          'boxes_lidar': np.array([[0, 0, 0, 4, 2, 1.6, 0.0],
                                   [10, 0, 0, 4, 2, 1.6, 0.0]]),
          'difficulty': np.array([1, 2]),
          'num_points_in_gt': np.array([30, 3])}
    det = {'name': np.array(['Vehicle', 'Vehicle']),
           'boxes_lidar': np.array([[0, 0, 0, 4, 2, 1.6, 0.0],
                                    [10, 0, 0, 4, 2, 1.6, np.pi]]),
           'score': np.array([0.9, 0.8])}
    for level in (1, 2):
        want = naive_evaluate_class([det], [gt], 'Vehicle', level)
        got = waymo_eval.evaluate_class_level([det], [gt], 'Vehicle', level,
                                              device='cpu')
        np.testing.assert_allclose(got, want, atol=1e-6)
    ap1, aph1 = waymo_eval.evaluate_class_level([det], [gt], 'Vehicle', 1,
                                                device='cpu')
    assert ap1 == pytest.approx(100.0, abs=1e-4)
    assert aph1 == pytest.approx(100.0, abs=1e-4)
    _, aph2 = waymo_eval.evaluate_class_level([det], [gt], 'Vehicle', 2,
                                              device='cpu')
    assert aph2 < 100.0


def test_empty_frames_and_classes():
    """Frames without detections or gts, and a class with no gts."""
    from glenet_tpu.eval import waymo_eval as jwe

    from glenet_tpu_torch.eval import waymo_eval as twe
    empty = {'name': np.array([], dtype='<U7'),
             'boxes_lidar': np.zeros((0, 7)), 'score': np.zeros(0)}
    gt = {'name': np.array(['Vehicle']),
          'boxes_lidar': np.array([[0, 0, 0, 4, 2, 1.6, 0.0]]),
          'num_points_in_gt': np.array([10])}
    det = dict(gt, score=np.array([0.5]))
    dets, gts = [empty, det, det], [gt, empty, gt]
    _, ref = jwe.waymo_evaluation(dets, gts, CLASSES)
    _, got = twe.waymo_evaluation(dets, gts, CLASSES, device='cpu')
    assert got == pytest.approx(ref, abs=1e-6)
