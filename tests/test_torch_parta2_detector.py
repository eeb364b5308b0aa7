"""Predict of PartA2 (PartA2Net) and PartA2-free (PointRCNN with UNetV2)
through the port's detector against glenet_tpu on the toy configs of
tests/test_parta2.py (make_parta2_cfg, make_parta2_free_cfg), one set of
numpy-drawn weights (through jax_weights) and points, f32 on both sides:
the part head's outputs, the proposals and the RCNN outputs rtol 1e-4 /
atol 1e-5; final valid masks and labels exact, boxes and scores atol 1e-4
(tests/torch_parity.py assert_predict_equal).  The train step is held in
tests/test_torch_parta2_train.py."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402


def _cfg(kind):
    from glenet_tpu.config import Cfg
    from test_parta2 import make_parta2_cfg, make_parta2_free_cfg
    cfg = make_parta2_cfg() if kind == 'PartA2' else make_parta2_free_cfg()
    cfg.OPTIMIZATION = Cfg(dict(tp.TINY_OPTIMIZATION))
    return cfg


@pytest.mark.parametrize('kind', ['PartA2', 'PartA2_free'])
def test_predict(kind):
    with tp.pinned_f32():
        jax_full, jax_pred, full, pred, _ = tp.run_predicts(_cfg(kind))
    for k in ('point_cls_preds', 'point_part_preds', 'point_coords') + (
            ('point_box_preds',) if kind == 'PartA2_free' else ()):
        tp.assert_close(full['part_head'][k], jax_full['part_head'][k],
                        err_msg=k)
    prop, jprop = full['proposals'], jax_full['proposals']
    np.testing.assert_array_equal(prop['roi_valid'].numpy(),
                                  jprop['roi_valid'])
    assert jprop['roi_valid'].sum() > 8
    np.testing.assert_array_equal(prop['roi_labels'].numpy(),
                                  jprop['roi_labels'])
    tp.assert_close(prop['rois'], jprop['rois'], err_msg='rois')
    for k in ('rcnn_cls', 'rcnn_reg'):
        tp.assert_close(full['rcnn'][k], jax_full['rcnn'][k], err_msg=k)
    tp.assert_predict_equal(pred, jax_pred)
