"""Parity of the port's PointPillars (pointpillar.yaml) with glenet_tpu on
a toy version of it (torch_parity.tiny_single_stage_cfg('PILLAR')): three
classes with second.yaml's anchors at feature_map_stride 2, 0.5 x 0.5 x 4 m
pillars of at most 4 points (a 32 x 32 x 1 grid, 512 pillar slots, so the
budget drops some), PillarVFE with two PFN layers, PointPillarScatter, a
stride-2 BaseBEVBackbone, AnchorHeadSingle and greedy nms_gpu.

Same numpy-drawn weights and points, f32 on both sides: the pillar
tables, the pillar features, the canvas (empty cells exactly 0) and the 2D
backbone's map; a predict at the config's thresholds and one at zero
thresholds; the anchor targets; one train step (every loss term, every
gradient, the BN running stats, the parameters after adam_onecycle).

Tolerances: integers exactly (pillar coords, masks and counts, target
labels, final labels and valid flags); floats rtol 1e-4 / atol 1e-5.  The
final boxes are held at rtol 1e-4 / atol 1e-5 alone: the random box head
decodes some sizes to ~1e4 m, where f32 rounding alone exceeds the other
families' extra atol 1e-4.  Gradients per tensor max |diff| <= 2e-4
max |grad| + 1e-6; parameters after the step as
tests/test_torch_train_step.py."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KIND = 'PILLAR'


def test_yaml_builds():
    """configs/kitti_models/pointpillar.yaml builds at full width on the
    CPU: the 432 x 496 x 1 pillar grid (np.round of range / voxel size),
    10 input features into one 64-wide PFN layer, 6 anchors per location
    of a 216 x 248 map."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(cfg_from_yaml_file(
        str(ROOT / 'configs/kitti_models/pointpillar.yaml')), device='cpu')
    assert det.grid_size == (432, 496, 1)
    assert det.max_points_per_voxel == 32
    assert det.net.backbone_3d is None
    assert det.net.vfe.PFNLayer_0.Dense_0.weight.shape == (64, 10)
    assert det.net.vfe.PFNLayer_0.Dense_0.bias is None
    assert det.anchor_set.anchors.shape[:3] == (248, 216, 6)


@pytest.fixture(scope='module')
def runs():
    return tp.single_stage_slice(KIND)


def test_stages(runs):
    """Pillars are dropped by the budget, some are full (4 points) and
    some hold one point."""
    counts = runs[2][0]['stages']['vox']['voxel_num_points']
    mask = runs[2][0]['stages']['vox']['voxel_mask']
    assert mask.all() and (counts == 4).any() and (counts == 1).any()
    tp.assert_single_stage_stages(runs[2])


@pytest.mark.parametrize('key', ['pred', 'pred_zero'])
def test_predict(runs, key):
    ref, got, _ = runs[2]
    assert ref[key]['final_valid'].any()
    for k in ('final_valid', 'final_labels'):
        np.testing.assert_array_equal(got[key][k].numpy(), ref[key][k])
    for k in ('final_boxes', 'final_scores'):
        tp.assert_close(got[key][k], ref[key][k], err_msg=k)


def test_targets(runs):
    tp.assert_single_stage_targets(runs[3])


def test_loss_terms(runs):
    ref, metrics, _, _, _ = runs[3]
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_gradients(runs):
    ref, _, grads, _, tdet = runs[3]
    assert 'vfe.PFNLayer_0.Dense_0.weight' in grads
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_bn_stats(runs):
    ref, _, _, _, tdet = runs[3]
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


def test_params_after_adam(runs):
    ref, _, grads, _, tdet = runs[3]
    lr = tp.TINY_OPTIMIZATION['LR'] / tp.TINY_OPTIMIZATION['DIV_FACTOR']
    tp.assert_params_after_adam(tdet, ref, grads, lr)
