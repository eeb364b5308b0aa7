"""Parity of the port's GLENet-S (GLENet_S.yaml) with glenet_tpu on a toy
version of it (torch_parity.tiny_single_stage_cfg('S'): tests/
test_second.py's TINY_SECOND on KITTI's z range): VoxelBackBone8x, BaseBEVBackbone and AnchorHeadKLLabel (the KL-label regression loss with its three parts), variance-voting final NMS over the dense head with POST_SCORE_THRESH.

Same numpy-drawn weights and points, f32 on both sides: the backbone's
stages, a predict at the config's thresholds and one at zero thresholds
(every NMS_PRE_MAXSIZE candidate live), the anchor targets, and one train
step (every loss term under JAX's metric names, every gradient, the BN
running stats, the parameters after adam_onecycle).

Tolerances: integers exactly (voxels, levels, target labels, final labels
and valid flags); floats rtol 1e-4 / atol 1e-5, final boxes and scores
also atol 1e-4; gradients per tensor max |diff| <= 2e-4 max |grad| +
1e-6; parameters after the step as tests/test_torch_train_step.py."""
from pathlib import Path

import pytest

jax = pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KIND = 'S'


def test_yaml_builds():
    """configs/kitti_models/GLENet_S.yaml builds at full width on the CPU."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(cfg_from_yaml_file(
        str(ROOT / 'configs/kitti_models/GLENet_S.yaml')), device='cpu')
    assert det.net.roi_head is None
    assert type(det.net.dense_head).__name__ == 'AnchorHeadKLLabel'
    assert det.net.dense_head.with_std_branch
    assert not det.net.dense_head.with_iou_branch
    assert type(det.net.backbone_2d).__name__ == 'BaseBEVBackbone'


@pytest.fixture(scope='module')
def runs():
    return tp.single_stage_slice(KIND)


def test_stages(runs):
    tp.assert_single_stage_stages(runs[2])


def test_predict(runs):
    tp.assert_single_stage_predict(runs[2], 'pred')


def test_predict_zero_thresholds(runs):
    cfg = runs[0].MODEL.POST_PROCESSING.NMS_CONFIG
    n = min(int(cfg.NMS_POST_MAXSIZE), int(cfg.NMS_PRE_MAXSIZE))
    assert runs[2][0]['pred_zero']['final_valid'].sum(1).min() == n
    tp.assert_single_stage_predict(runs[2], 'pred_zero')


def test_targets(runs):
    tp.assert_single_stage_targets(runs[3])


def test_loss_terms(runs):
    ref, metrics, _, _, _ = runs[3]
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_gradients(runs):
    ref, _, grads, _, tdet = runs[3]
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_bn_stats(runs):
    ref, _, _, _, tdet = runs[3]
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


def test_params_after_adam(runs):
    ref, _, grads, _, tdet = runs[3]
    lr = tp.TINY_OPTIMIZATION['LR'] / tp.TINY_OPTIMIZATION['DIV_FACTOR']
    tp.assert_params_after_adam(tdet, ref, grads, lr)
