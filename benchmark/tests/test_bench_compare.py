"""The detection comparison's NMS check on a hand-made scene: the
reference's own final set passes, and a set that keeps an overlapping
pair, leaves a box out or holds a box that is no candidate does not."""
import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import waymo_centerpoint as ref_cp

NMS = {'thresh': 0.7, 'score_thresh': 0.1, 'top_k': 7, 'post_max': 7}
CELL_M = 0.8


def _scene():
    """8 cells of one class: 1 overlaps 0 (IoU 0.95), 4 meets 3 (IoU
    0.14), 6 scores under the threshold, 7 lies outside the top k."""
    boxes = torch.tensor([[0.0, 0, 0, 4, 2, 1.5, 0.0],
                          [0.1, 0, 0, 4, 2, 1.5, 0.0],
                          [10, 0, 0, 4, 2, 1.5, 0.3],
                          [20, 0, 0, 4, 2, 1.5, 0.0],
                          [20, 1.5, 0, 4, 2, 1.5, 0.0],
                          [30, 0, 0, 4, 2, 1.5, 0.0],
                          [40, 0, 0, 4, 2, 1.5, 0.0],
                          [50, 0, 0, 4, 2, 1.5, 0.0]])
    scores = torch.tensor([[0.9], [0.8], [0.7], [0.6], [0.5], [0.4],
                           [0.05], [0.04]])
    kb, ks, kl, _ = ref_cp.top_k(boxes, scores, NMS['top_k'])
    ks = torch.where(ks >= NMS['score_thresh'], ks, 0.0)
    keep = ref_cp.nms(kb.numpy(), ks.numpy(), NMS['thresh'],
                      NMS['score_thresh'], NMS['post_max'])
    ref = {'boxes': kb.numpy()[keep], 'scores': ks.numpy()[keep],
           'labels': kl.numpy()[keep], 'keep': keep, 'all_boxes': boxes,
           'all_scores': scores, 'all_rot': torch.ones(8, 2)}
    return ref, kb.numpy(), ks.numpy()


def _prog(kb, ks, ranks, moved=None):
    boxes = kb[ranks].copy()
    if moved is not None:
        boxes[moved, 0] += 1.0
    return {'boxes': boxes, 'scores': ks[ranks],
            'labels': np.ones(len(ranks), np.int64)}


@pytest.mark.parametrize('ranks,moved,faults', [
    ([0, 2, 3, 4, 5], None, {}),                  # the reference's own set
    ([0, 1, 2, 3, 4, 5], None, {'overlap': 1}),   # NMS left out
    ([0, 3, 4, 5], None, {'missing': 1}),         # a kept box left out
    ([1, 2, 3, 4, 5], None, {'missing': 1}),      # the lower of a pair kept
    ([0, 2, 3, 4, 5], 1, {'foreign': 1, 'missing': 1}),   # a box moved 1 m
    ([0, 2, 3, 4, 5, 6], None, {'foreign': 1}),   # a box under the threshold
])
def test_nms_check(ranks, moved, faults):
    ref, kb, ks = _scene()
    assert list(ref['keep']) == [0, 2, 3, 4, 5]
    out = compare.detection_numbers(_prog(kb, ks, ranks, moved), ref,
                                    CELL_M, NMS)
    for k in ('foreign', 'overlap', 'missing'):
        assert out[k] == faults.get(k, 0), k
    assert out['nms_faults'] == sum(faults.values())
