"""Parity of the port's SECOND-IoU (second_iou.yaml: SECONDNetIoU,
AnchorHeadSingle, SECONDHead) with glenet_tpu on a toy version of it
(torch_parity.tiny_single_stage_cfg('IOU')): three classes with
second.yaml's anchors, the proposal NMS, SECONDHead's rotated 4 x 4 grid
bilinearly sampled from the 2D backbone's 4 x 4 map (most rois cross its
edge) and its IoU logit; the final nms_gpu over the rois scored by the
sigmoid of that logit.

Same numpy-drawn weights and points, f32 on both sides:
  - a predict: the proposals (rois, labels, valid flags), the IoU logits,
    the final boxes, scores, labels and valid flags;
  - one train step with JAX's own RoI draws fed to the port (gt boxes
    0.15 m off the first 4 train-mode proposals of each sample, with
    their labels, so fg rois exist; DP_RATIO 0): every loss term (the
    IoU's BCE under rcnn_iou_weight and no regression term), every
    gradient and the BN running stats.

Tolerances: integers exactly; floats rtol 1e-4 / atol 1e-5, final boxes
and scores also atol 1e-4; loss terms rtol 1e-4; gradients per tensor
max |diff| <= 2e-4 max |grad| + 1e-6."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def test_yaml_builds():
    """configs/kitti_models/second_iou.yaml builds at full width on the
    CPU: SECONDHead over the 512-channel map, 7 x 7 grid, FCs of 256."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(cfg_from_yaml_file(
        str(ROOT / 'configs/kitti_models/second_iou.yaml')), device='cpu')
    head = det.net.roi_head
    assert type(head).__name__ == 'SECONDHead'
    assert head.shared_0.weight.shape == (256, 7 * 7 * 512)
    assert head.iou_pred.weight.shape == (1, 256)
    assert det.net.dense_head.conv_cls.weight.shape[0] == 6 * 3


@pytest.fixture(scope='module')
def cfg():
    return tp.tiny_single_stage_cfg('IOU')


@pytest.fixture(scope='module')
def predicts(cfg):
    with tp.pinned_f32():
        return tp.run_predicts(cfg)


@pytest.fixture(scope='module')
def step(cfg):
    with tp.pinned_f32():
        return tp.run_train_steps(cfg)


def test_proposals(predicts):
    jax_full, _, full, _, _ = predicts
    ref, got = jax_full['proposals'], full['proposals']
    for k in ('roi_labels', 'roi_valid'):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    assert len(np.unique(ref['roi_labels'][ref['roi_valid']])) > 1
    tp.assert_close(got['rois'], ref['rois'])
    tp.assert_close(got['roi_scores'], ref['roi_scores'])


def test_iou_logits(predicts):
    jax_full, _, full, _, _ = predicts
    tp.assert_close(full['rcnn']['rcnn_cls'], jax_full['rcnn']['rcnn_cls'])
    assert not full['rcnn']['rcnn_reg'].any()


def test_predict(predicts):
    _, jax_pred, _, pred, _ = predicts
    tp.assert_predict_equal(pred, jax_pred)
    for k in ('final_boxes', 'final_scores'):
        tp.assert_close(pred[k], jax_pred[k], err_msg=k)


def test_loss_terms(step):
    ref, metrics, _, _ = step
    assert ref['targets']['reg_valid_mask'].sum() > 0
    assert 'rcnn_loss_reg' not in metrics and 'rcnn_loss_cls' in metrics
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_gradients(step):
    ref, _, grads, tdet = step
    assert float(grads['roi_head.iou_pred.weight'].abs().max()) > 0
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_bn_stats(step):
    ref, _, _, tdet = step
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])
