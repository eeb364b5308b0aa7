"""Parity of the port's KITTI evaluator with glenet_tpu's on random frames.

The frames hold Car / Van / Pedestrian / Cyclist / DontCare labels over all
three difficulties (2D heights, occlusion and truncation drawn across the
gates), detections that are perturbed copies of the gts at several IoU
levels, false positives (some small enough to be ignored, some inside a
DontCare region), and empty frames of every kind (no gt, no detection,
neither).  The port runs its overlaps and matcher on the CPU here.

Tolerances: every `ret_dict` value within 1e-3 AP points and the result
strings equal (the matching decisions are the same; only the f32 / f64 sums
of the orientation similarity differ).  The BEV / 3D IoU matrices: the
port's within atol 1e-5 of the exact ones (the same overlaps in float64),
and the two packages within 1e-5 plus glenet_tpu's own distance from the
exact value.  glenet_tpu clips each pair at the boxes' camera coordinates
in f32, where the shoelace sum of corners 60 m out loses up to ~6e-4 of an
IoU on these frames; the port clips each pair about its gt box's centre."""
import numpy as np
import pytest

pytest.importorskip('jax')

N_FRAMES = 28
NAMES = ['Car', 'Car', 'Car', 'Car', 'Van', 'Pedestrian', 'Cyclist']
SIZES = {'Car': (3.9, 1.56, 1.6), 'Van': (5.0, 2.1, 1.9),
         'Pedestrian': (0.8, 1.75, 0.6), 'Cyclist': (1.76, 1.73, 0.6)}


def _gt_frame(rng, n):
    names, bbox, loc, dims, ry, occ, trunc = [], [], [], [], [], [], []
    for _ in range(n):
        name = NAMES[rng.randint(len(NAMES))]
        l, h, w = np.asarray(SIZES[name]) * rng.uniform(0.9, 1.1, 3)
        x1, y1 = rng.uniform(0, 1100), rng.uniform(120, 220)
        height = rng.choice([18.0, 30.0, 45.0, 90.0]) * rng.uniform(0.9, 1.1)
        names.append(name)
        bbox.append([x1, y1, x1 + height * rng.uniform(0.6, 2.0),
                     y1 + height])
        loc.append([rng.uniform(-15, 15), rng.uniform(1.4, 1.9),
                    rng.uniform(5, 60)])
        dims.append([l, h, w])
        ry.append(rng.uniform(-np.pi, np.pi))
        occ.append(rng.choice([0, 0, 1, 2, 3]))
        trunc.append(rng.choice([0.0, 0.0, 0.1, 0.2, 0.4, 0.6]))
    n_dc = rng.randint(0, 3)
    for _ in range(n_dc):
        x1, y1 = rng.uniform(0, 1100), rng.uniform(120, 220)
        names.append('DontCare')
        bbox.append([x1, y1, x1 + rng.uniform(40, 120),
                     y1 + rng.uniform(30, 80)])
        loc.append([-1000.0, -1000.0, -1000.0])
        dims.append([-1.0, -1.0, -1.0])
        ry.append(-10.0)
        occ.append(-1)
        trunc.append(-1.0)
    k = len(names)
    return {'name': np.array(names, dtype='<U10'),
            'truncated': np.array(trunc, np.float64),
            'occluded': np.array(occ, np.int64),
            'alpha': rng.uniform(-np.pi, np.pi, k),
            'bbox': np.array(bbox, np.float64).reshape(k, 4),
            'dimensions': np.array(dims, np.float64).reshape(k, 3),
            'location': np.array(loc, np.float64).reshape(k, 3),
            'rotation_y': np.array(ry, np.float64)}


def _dt_frame(rng, gt, with_alpha):
    names, bbox, loc, dims, ry, alpha = [], [], [], [], [], []
    for i in range(len(gt['name'])):
        if gt['name'][i] == 'DontCare':
            # a false positive inside the DontCare region (metric 0 ignores
            # it when it lies mostly inside)
            if rng.uniform() < 0.7:
                b = gt['bbox'][i]
                names.append('Car')
                bbox.append([b[0] + 2, b[1] + 2, b[0] + 0.7 * (b[2] - b[0]),
                             b[3] - 2])
                loc.append([rng.uniform(-15, 15), 1.6, rng.uniform(5, 60)])
                dims.append(SIZES['Car'])
                ry.append(rng.uniform(-np.pi, np.pi))
                alpha.append(rng.uniform(-np.pi, np.pi))
            continue
        if rng.uniform() < 0.15:                    # a missed gt
            continue
        sigma = rng.choice([0.03, 0.15, 0.4, 1.0])  # IoU levels
        names.append('Car' if gt['name'][i] == 'Van' and rng.uniform() < 0.5
                     else gt['name'][i])
        bbox.append(gt['bbox'][i] + rng.normal(0, 8 * sigma, 4))
        loc.append(gt['location'][i] + rng.normal(0, sigma, 3))
        dims.append(gt['dimensions'][i] * (1 + rng.normal(0, 0.1 * sigma, 3)))
        ry.append(gt['rotation_y'][i] + rng.normal(0, 0.3 * sigma))
        alpha.append(gt['alpha'][i] + rng.normal(0, 0.5))
    for _ in range(rng.randint(0, 4)):              # false positives
        name = ['Car', 'Pedestrian', 'Cyclist'][rng.randint(3)]
        x1, y1 = rng.uniform(0, 1100), rng.uniform(120, 220)
        height = rng.choice([20.0, 50.0])
        names.append(name)
        bbox.append([x1, y1, x1 + height, y1 + height])
        loc.append([rng.uniform(-15, 15), 1.6, rng.uniform(5, 60)])
        dims.append(SIZES[name])
        ry.append(rng.uniform(-np.pi, np.pi))
        alpha.append(rng.uniform(-np.pi, np.pi))
    k = len(names)
    return {'name': np.array(names, dtype='<U10'),
            'truncated': np.zeros(k), 'occluded': np.zeros(k),
            'alpha': (np.array(alpha, np.float64) if with_alpha
                      else np.full(k, -10.0)),
            'bbox': np.array(bbox, np.float64).reshape(k, 4),
            'dimensions': np.array(dims, np.float64).reshape(k, 3),
            'location': np.array(loc, np.float64).reshape(k, 3),
            'rotation_y': np.array(ry, np.float64),
            'score': rng.uniform(0, 1, k)}


def _empty_dt():
    return {'name': np.zeros(0, '<U10'), 'truncated': np.zeros(0),
            'occluded': np.zeros(0), 'alpha': np.zeros(0),
            'bbox': np.zeros((0, 4)), 'dimensions': np.zeros((0, 3)),
            'location': np.zeros((0, 3)), 'rotation_y': np.zeros(0),
            'score': np.zeros(0)}


def make_frames(seed, with_alpha=True):
    """N_FRAMES (gt, dt) anno pairs: frames 0-2 are empty in turn (no gt,
    no detection, neither), the rest random."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for f in range(N_FRAMES):
        gt = _gt_frame(rng, 0 if f in (0, 2) else rng.randint(1, 9))
        dt = _empty_dt() if f in (1, 2) else _dt_frame(rng, gt, with_alpha)
        gts.append(gt)
        dts.append(dt)
    return gts, dts


@pytest.mark.parametrize('seed,classes,with_alpha', [
    (0, ['Car'], True),
    (1, ['Car', 'Pedestrian', 'Cyclist'], True),
    (2, ['Car', 'Pedestrian'], False),
])
def test_official_eval_result(seed, classes, with_alpha):
    from glenet_tpu.eval import kitti_eval as jeval

    from glenet_tpu_torch.eval import kitti_eval as teval
    gts, dts = make_frames(seed, with_alpha)
    ref_str, ref = jeval.get_official_eval_result(gts, dts, classes)
    got_str, got = teval.get_official_eval_result(gts, dts, classes,
                                                  device='cpu')
    assert set(got) == set(ref)
    assert ('Car_aos/easy_R40' in ref) == with_alpha
    for k, v in ref.items():
        assert abs(float(got[k]) - float(v)) <= 1e-3, (k, got[k], v)
    assert got_str == ref_str
    # the frames exercise the matcher: some AP is neither 0 nor 100
    assert any(0 < v < 100 for v in ref.values())


def _exact_overlaps(gt, dt):
    """BEV and 3D IoU of one frame from float64 overlaps."""
    import torch

    from glenet_tpu_torch.eval import kitti_eval as teval
    from glenet_tpu_torch.ops import iou3d
    g, d = (torch.from_numpy(teval._to7(teval._camera_bev_boxes(a))
                             .astype(np.float64)) for a in (gt, dt))
    inter = iou3d.boxes_overlap_bev(g, d).numpy()
    return teval._bev_iou(gt, dt, inter), teval._d3_iou(gt, dt, inter)


def test_overlap_matrices():
    from glenet_tpu.eval import kitti_eval as jeval

    from glenet_tpu_torch.eval import kitti_eval as teval
    gts, dts = make_frames(3)
    n_overlapping = 0
    for gt, dt in zip(gts, dts):
        exact = _exact_overlaps(gt, dt)
        for jfn, tfn, ex in ((jeval.bev_box_overlap, teval.bev_box_overlap,
                              exact[0]),
                             (jeval.d3_box_overlap, teval.d3_box_overlap,
                              exact[1])):
            ref = jfn(gt, dt)
            got = tfn(gt, dt, device='cpu')
            assert got.shape == ref.shape == ex.shape
            np.testing.assert_allclose(got, ex, rtol=0, atol=1e-5)
            assert (np.abs(got - ref) <= np.abs(ref - ex) + 1e-5).all()
            assert np.abs(ref - ex).max(initial=0) < 1e-3
            n_overlapping += int((ref > 0.1).sum())
    assert n_overlapping > 50


def test_frame_overlaps_batched_equal_per_frame():
    """The port's one-batch overlaps of all frames equal its per-frame
    overlaps (the padding of the batch changes nothing but the order of
    f32 operations)."""
    from glenet_tpu_torch.eval import kitti_eval as teval
    gts, dts = make_frames(4)
    for metric, fn in ((1, teval.bev_box_overlap), (2, teval.d3_box_overlap)):
        batched = teval.frame_overlaps(gts, dts, metric, 'cpu')
        for gt, dt, ov in zip(gts, dts, batched):
            np.testing.assert_allclose(
                ov, fn(gt, dt, device='cpu').T.astype(np.float32), rtol=0,
                atol=1e-6)


@pytest.mark.parametrize('metric', [0, 1, 2])
def test_eval_class_curves(metric):
    """Precision / recall / orientation curves of one cell per metric, at
    the moderate difficulty and the strict Car overlap."""
    from glenet_tpu.eval import kitti_eval as jeval

    from glenet_tpu_torch.eval import kitti_eval as teval
    gts, dts = make_frames(5)
    mo = [0.7, 0.7, 0.7][metric]
    ref = jeval.eval_class(gts, dts, 0, 1, metric, mo, compute_aos=True)
    got = teval.eval_class(gts, dts, 0, 1, metric, mo, compute_aos=True,
                           device='cpu')
    for k in ('precision', 'recall', 'orientation'):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert ref['precision'].max() > 0
