"""The port's data-parallel step on 2 gloo ranks x B = 1 against its own
one-process step on the B = 2 global batch, for the two-stage families
(toy configs of their parity tests, DP_RATIO 0.3 where the head has
dropout, the port's own RoI sampling and dropout draws): loss terms,
grad_norm, gradients, parameters, Adam moments and BN statistics within
tests/test_torch_train_step.py's tolerances (torch_dist.assert_step_equal),
every integer decision of the step (anchor targets, proposals, sampled
RoIs, reg_valid_mask, merge-resolve tables) exactly on each rank's rows,
and the BN statistics bit-equal across the ranks.  Rank 1 starts from
other weights: put_replicated must make them rank 0's.  Gradients may also
move by twice what adding the BN sums rank by rank moves them in one
process (torch_dist.reference_step's noise), and each rank takes the
reference's side of a ReLU kink within rounding
(torch_dist.align_relu_kinks).  The single-stage, CenterHead and camera
families are in test_torch_parallel_single.py."""
import copy

import numpy as np
import pytest

pytest.importorskip('jax')

import torch_dist as td  # noqa: E402
import torch_parity as tp  # noqa: E402

WORLD = 2


def _make_batch(cfg, n_points=1024, seed=3, points=None):
    from __graft_entry__ import _make_batch as make
    batch = {k: np.array(v) for k, v in make(
        WORLD, n_points=n_points, n_gt=8, seed=seed,
        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)).items()}
    if points is not None:
        batch.update(points=points,
                     points_mask=np.ones(points.shape[:2], bool))
    return batch


def _pvrcnn_points():
    rng = np.random.RandomState(21)
    pts = np.zeros((2, 1024, 4), np.float32)
    pts[..., 0] = rng.uniform(0, 16, (2, 1024))
    pts[..., 1] = rng.uniform(-8, 8, (2, 1024))
    pts[..., 2] = rng.uniform(-1.1, 1.1, (2, 1024))
    pts[..., 3] = rng.uniform(0, 1, (2, 1024))
    return pts


def _pointrcnn_points():
    rng = np.random.RandomState(31)
    n = 512
    pts = np.zeros((2, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0, 16, (2, n))
    pts[..., 1] = rng.uniform(-8, 8, (2, n))
    pts[..., 2] = rng.uniform(-1.1, 1.1, (2, n))
    k = n // 3
    centres = rng.uniform([3, -5, -0.5], [13, 5, 0.5], (2, 6, 3))
    pts[:, :k, :3] = (centres[:, rng.randint(0, 6, k)]
                      + rng.randn(2, k, 3) * [1.0, 0.5, 0.3])
    pts[..., 3] = rng.uniform(0, 1, (2, n))
    return pts


def _glenet_vr():
    return tp.tiny_twostage_cfg(512), {}


def _parta2(kind):
    from test_torch_parta2_detector import _cfg
    return _cfg(kind), {}


def _pvrcnn():
    return tp.tiny_pvrcnn_cfg(), {'points': _pvrcnn_points()}


def _pvpp():
    from test_torch_pvrcnn_plusplus import GT_OFFSET
    return tp.tiny_pvpp_cfg(), {'gt_offset': GT_OFFSET}


def _pointrcnn():
    from glenet_tpu.config import Cfg
    from test_pointrcnn import make_two_stage_cfg
    cfg = make_two_stage_cfg()
    cfg.OPTIMIZATION = Cfg(dict(tp.TINY_OPTIMIZATION))
    return cfg, {'points': _pointrcnn_points()}


def _second_iou():
    return tp.tiny_single_stage_cfg('IOU'), {}


def _center_rpn_dyn():
    from test_torch_centerpoint import GT_OFFSET, two_stage_cfg
    return two_stage_cfg('voxel_rcnn_dyn'), {'gt_offset': GT_OFFSET}


CASES = {'GLENet-VR': _glenet_vr,
         'PartA2': lambda: _parta2('PartA2'),
         'PartA2-free': lambda: _parta2('PartA2_free'),
         'PV-RCNN': _pvrcnn, 'PV-RCNN++': _pvpp, 'PointRCNN': _pointrcnn,
         'SECOND-IoU': _second_iou,
         'Voxel R-CNN, CenterHead RPN, dynamic voxels': _center_rpn_dyn}


def two_stage_case(name, make):
    """(name, port cfg, start weights, global batch with gts off the
    proposals) of one family."""
    cfg, kw = make()
    cfg = copy.deepcopy(cfg)
    if 'DP_RATIO' in cfg.MODEL.ROI_HEAD:
        cfg.MODEL.ROI_HEAD.DP_RATIO = 0.3
    tcfg = tp.to_port_cfg(cfg)
    batch = _make_batch(cfg, points=kw.get('points'))
    weights = td.jax_drawn_weights(cfg, tcfg, batch)
    batch = td.gts_from_proposals(tcfg, weights, batch,
                                  gt_offset=kw.get('gt_offset', (0.15,)))
    return name, tcfg, weights, batch


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    with tp.pinned_f32():
        cases = [two_stage_case(n, m) for n, m in CASES.items()]
        return td.run_cases(cases, tmp_path_factory.mktemp('dp_two_stage'))


@pytest.mark.parametrize('name', list(CASES))
def test_two_stage_family(runs, name):
    td.assert_family(name, *runs[name])
