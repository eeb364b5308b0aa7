"""The port's IoU and NMS (glenet_tpu_torch/ops/{iou3d,nms}.py) against
glenet_tpu's on the same boxes, scores and variances: indices and validity
exact, IoUs and voted boxes at atol 1e-5 (f32 polygon clipping, sums in
another order)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

from glenet_tpu.ops import iou3d as jiou  # noqa: E402
from glenet_tpu.ops import nms as jnms  # noqa: E402

from glenet_tpu_torch.ops import iou3d as tiou  # noqa: E402
from glenet_tpu_torch.ops import nms as tnms  # noqa: E402


def _boxes(seed, n, spread=20.0):
    r = np.random.RandomState(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = r.uniform(0, spread, (n, 2))
    b[:, 2] = r.uniform(-1, 1, n)
    b[:, 3] = r.uniform(2.5, 4.5, n)
    b[:, 4] = r.uniform(1.2, 2.0, n)
    b[:, 5] = r.uniform(1.2, 1.8, n)
    b[:, 6] = r.uniform(-np.pi, np.pi, n)
    scores = r.uniform(0, 1, n).astype(np.float32)
    return b, scores


def test_iou_bev():
    a, _ = _boxes(0, 40, spread=8.0)
    b, _ = _boxes(1, 30, spread=8.0)
    ref = jiou.boxes_iou_bev(a, b)
    got = tiou.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b))
    assert (np.asarray(ref) > 0).sum() > 20
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    blk = tiou.boxes_iou_bev_blocked(torch.from_numpy(a), torch.from_numpy(b),
                                     block_rows=16)
    np.testing.assert_allclose(blk.numpy(), got.numpy(), atol=0)


@pytest.mark.parametrize('n,pre_max,post_max', [
    (300, 256, 64),      # full-matrix greedy pass
    (1200, 1024, 100),   # lazy blocked pass with its early exit
    (800, 768, 800),     # lazy pass to the end of the candidates
])
def test_nms_bev(n, pre_max, post_max):
    boxes, scores = _boxes(n, n, spread=30.0)
    scores[::7] = scores[3]          # ties: the lower index goes first
    ref_idx, ref_valid = jnms.nms_bev(boxes, scores, 0.3, pre_max=pre_max,
                                      post_max=post_max, score_threshold=0.1)
    idx, valid = tnms.nms_bev(torch.from_numpy(boxes),
                              torch.from_numpy(scores), 0.3, pre_max=pre_max,
                              post_max=post_max, score_threshold=0.1)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy()[valid.numpy()],
                                  np.asarray(ref_idx)[np.asarray(ref_valid)])


@pytest.mark.parametrize('seed', [0, 1])
def test_variance_voting_nms(seed):
    boxes, scores = _boxes(seed, 100, spread=12.0)
    boxes[:, 6] = np.where(np.arange(100) % 5 == 0, 3.1, boxes[:, 6])
    var = np.exp(np.random.RandomState(seed + 9).normal(
        -2, 0.5, (100, 7))).astype(np.float32)
    ref = jnms.variance_voting_nms(boxes, scores, var, 0.1, pre_max=64,
                                   post_max=32, score_threshold=0.2)
    got = tnms.variance_voting_nms(torch.from_numpy(boxes),
                                   torch.from_numpy(scores),
                                   torch.from_numpy(var), 0.1, pre_max=64,
                                   post_max=32, score_threshold=0.2)
    ref_valid = np.asarray(ref[1])
    assert ref_valid.sum() > 3
    np.testing.assert_array_equal(got[1].numpy(), ref_valid)
    np.testing.assert_array_equal(got[0].numpy()[ref_valid],
                                  np.asarray(ref[0])[ref_valid])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-5)
