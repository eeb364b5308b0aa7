"""Parity of the port's SECOND-multihead (second_multihead.yaml) with
glenet_tpu on a toy version of it (torch_parity.tiny_single_stage_cfg(
'MULTIHEAD')): three classes with second.yaml's anchors, VoxelBackBone8x,
BaseBEVBackbone, AnchorHeadMulti (a 16-channel shared conv; Car alone and
Pedestrian with Cyclist in one head, so a head predicts two classes and
the other classes get the constant -20 logit), and the per-class final
NMS (MULTI_CLASSES_NMS) merged into the post_max slots.

Same numpy-drawn weights and points, f32 on both sides: the backbone's
stages, a predict at the config's thresholds and one at zero thresholds
(every NMS_PRE_MAXSIZE candidate live, in every class), the anchor
targets, and one train step (every loss term, every gradient, the BN
running stats, the parameters after adam_onecycle).

Tolerances: integers exactly (voxels, levels, target labels, final labels
and valid flags); floats rtol 1e-4 / atol 1e-5, final boxes and scores
also atol 1e-4; gradients per tensor max |diff| <= 2e-4 max |grad| +
1e-6; parameters after the step as tests/test_torch_train_step.py."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KIND = 'MULTIHEAD'


def test_yaml_builds():
    """configs/kitti_models/second_multihead.yaml builds at full width on
    the CPU: one head per class over second.yaml's 6 anchors per
    location."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(cfg_from_yaml_file(
        str(ROOT / 'configs/kitti_models/second_multihead.yaml')),
        device='cpu')
    head = det.net.dense_head
    assert type(head).__name__ == 'AnchorHeadMulti'
    assert head.groups == [([0], 2), ([1], 2), ([2], 2)]
    assert head.shared_conv.Conv_0.weight.shape == (64, 512, 3, 3)


def test_rpn_head_cfgs_must_partition_the_classes():
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = tp.to_port_cfg(tp.tiny_single_stage_cfg(KIND))
    cfg.MODEL.DENSE_HEAD.RPN_HEAD_CFGS[1]['HEAD_CLS_NAME'] = [
        'Cyclist', 'Pedestrian']
    with pytest.raises(ValueError, match='partition'):
        build_detector(cfg, device='cpu')


@pytest.fixture(scope='module')
def runs():
    return tp.single_stage_slice(KIND)


def test_stages(runs):
    tp.assert_single_stage_stages(runs[2])


def test_predict(runs):
    tp.assert_single_stage_predict(runs[2], 'pred')


def test_predict_zero_thresholds(runs):
    """Every class keeps boxes, and the merged slots hold the top scores
    over all classes in descending order."""
    pred = runs[2][0]['pred_zero']
    cfg = runs[0].MODEL.POST_PROCESSING.NMS_CONFIG
    assert pred['final_valid'].sum(1).min() == int(cfg.NMS_POST_MAXSIZE)
    for b in range(pred['final_scores'].shape[0]):
        s = pred['final_scores'][b]
        assert (np.diff(s) <= 0).all()
    tp.assert_single_stage_predict(runs[2], 'pred_zero')


def test_targets(runs):
    tp.assert_single_stage_targets(runs[3])


def test_loss_terms(runs):
    ref, metrics, _, _, _ = runs[3]
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_gradients(runs):
    ref, _, grads, _, tdet = runs[3]
    assert any(k.startswith('dense_head.head1_conv_cls') for k in grads)
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_bn_stats(runs):
    ref, _, _, _, tdet = runs[3]
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


def test_params_after_adam(runs):
    ref, _, grads, _, tdet = runs[3]
    lr = tp.TINY_OPTIMIZATION['LR'] / tp.TINY_OPTIMIZATION['DIV_FACTOR']
    tp.assert_params_after_adam(tdet, ref, grads, lr)
