"""Parity of the port's plain Voxel R-CNN (configs/kitti_models/
voxel_rcnn_car.yaml: ROI_HEAD.NAME VoxelRCNNHead, no POST_SCORE_THRESH,
final NMS nms_gpu) with glenet_tpu on the toy two-stage topology, same
numpy-drawn weights and points, f32 on both sides.

The plain head has no reg_std and no variance -> confidence branch: its
rcnn_cls is the raw logit, its regression loss the weighted smooth-L1, and
the final NMS is greedy rotated-BEV NMS on the scores at or above
SCORE_THRESH.  Tolerances as tests/test_torch_detector.py (predict) and
tests/test_torch_train_step.py (one train step with the JAX step's RoI
targets)."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _toy_cfg(dp_ratio=None):
    cfg = tp.plain_voxel_rcnn_cfg(tp.tiny_twostage_cfg(512))
    if dp_ratio is not None:
        cfg.MODEL.ROI_HEAD.DP_RATIO = dp_ratio
    return cfg


def test_voxel_rcnn_car_yaml_builds():
    """The repository's voxel_rcnn_car.yaml builds a plain head: no
    variance branch among its parameters."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/'
                                        'voxel_rcnn_car.yaml'))
    det = build_detector(cfg, device='cpu')
    names = [n for n, _ in det.net.roi_head.named_parameters()]
    assert not det.net.roi_head.kl_label
    assert not any(n.startswith(('reg_std', 'std_')) for n in names)
    assert 'cls_pred.weight' in names and 'reg_pred.weight' in names


@pytest.fixture(scope='module')
def predicts():
    with tp.pinned_f32():
        return tp.run_predicts(_toy_cfg())


def test_toy_predict_rcnn(predicts):
    jax_full, _, full, _, _ = predicts
    assert 'rcnn_reg_std' not in full['rcnn']
    assert 'rcnn_reg_std' not in jax_full['rcnn']
    np.testing.assert_array_equal(full['proposals']['roi_valid'].numpy(),
                                  jax_full['proposals']['roi_valid'])
    for k in ('rcnn_cls', 'rcnn_reg'):
        tp.assert_close(full['rcnn'][k], jax_full['rcnn'][k], err_msg=k)


def test_toy_predict(predicts):
    """nms_gpu: the final scores are the sigmoid of the raw logits of the
    kept rois."""
    _, jax_pred, full, pred, _ = predicts
    tp.assert_predict_equal(pred, jax_pred)
    valid = pred['final_valid']
    scores = torch.sigmoid(full['rcnn']['rcnn_cls']).reshape(
        valid.shape[0], -1)
    for b in range(valid.shape[0]):
        kept = pred['final_scores'][b][valid[b]]
        assert all(bool(torch.isclose(scores[b], s).any()) for s in kept)


@pytest.fixture(scope='module')
def train_steps():
    with tp.pinned_f32():
        return tp.run_train_steps(_toy_cfg(dp_ratio=0.0))


def test_toy_train_step_loss_terms(train_steps):
    """The plain head's terms: no src / square / log KL parts."""
    ref, metrics, _, _ = train_steps
    assert ref['targets']['reg_valid_mask'].sum() > 0
    assert 'rcnn_loss_reg_src' not in metrics
    assert float(metrics['rcnn_loss_reg']) > 0
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_toy_train_step_gradients(train_steps):
    ref, _, grads, tdet = train_steps
    tp.assert_grads_equal(grads, ref['grads'], tdet)


def test_toy_train_step_bn_stats(train_steps):
    ref, _, _, tdet = train_steps
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])
