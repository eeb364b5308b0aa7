"""Self-tests of torch_parity's stage-wise predict comparison
(assert_single_stage_predict's fallback, assert_candidates_equal) on
hand-made candidates: a swap of two slots is taken only within the tie
bound of their JAX scores, and a moved box or a flipped kept flag fails.

One sample of six ranked candidates (CenterPoint's top-k decode gives such
a list); slots 2 and 3 are the tied pair, the final NMS keeps the first
four."""
import numpy as np
import pytest
import torch

import torch_parity as tp

SCORES = np.float32([0.9, 0.7, 0.53, 0.53, 0.3, 0.2])


def _candidates(gap):
    """JAX's candidates with slot 3 scored `gap` under slot 2, and the
    port's with the two slots swapped and both scored as slot 3."""
    rng = np.random.RandomState(0)
    s = SCORES.copy()
    s[3] = s[2] - np.float32(gap)
    ref = {'boxes': rng.uniform(-5, 5, (1, 6, 7)).astype(np.float32),
           'scores': s[None], 'labels': np.int32([[1, 2, 3, 4, 1, 2]]),
           'std': np.zeros((1, 6, 7), np.float32), 'cls_scores': None}
    perm = [0, 1, 3, 2, 4, 5]
    got = {k: None if v is None else v[:, perm].copy()
           for k, v in ref.items()}
    got['scores'][0, 2] = got['scores'][0, 3]
    return got, ref


def _final(c, keep=4):
    """The first `keep` candidates as the final slots of a predict."""
    return {'final_boxes': c['boxes'][:, :keep],
            'final_scores': c['scores'][:, :keep],
            'final_labels': c['labels'][:, :keep],
            'final_valid': np.ones((1, keep), bool)}


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _predicts(gap, fed_flip=False):
    """(ref, got, variables) as run_single_stage_predicts returns them:
    the port's final slots follow its swapped candidates; its final NMS on
    JAX's candidates gives JAX's slots, or with `fed_flip` drops one."""
    got_c, ref_c = _candidates(gap)
    fed = _final(ref_c)
    if fed_flip:
        fed['final_valid'][0, 3] = False
    ref = {'pred': _final(ref_c), 'candidates': {'pred': ref_c}}
    got = {'pred': _torch(_final(got_c)), 'candidates': {'pred': got_c},
           'fed': {'pred': _torch(fed)}}
    return ref, got, None


def test_tie_bound_is_a_few_ulps():
    for s in (0.4, 0.5, 0.53):
        ulps = tp.tie_bound(s) / np.spacing(np.float32(s))
        assert 4 <= ulps <= 8, (s, ulps)
    assert tp.tie_bound(0.5) < 1e-6


@pytest.mark.parametrize('case', ['swap_in_tie', 'swap_1e-3', 'box_1e-3',
                                  'score_beyond_rounding',
                                  'fed_flag_flipped', 'no_tie_positional'])
def test_stagewise_predict(case):
    one_ulp = float(np.spacing(np.float32(0.53)))
    if case == 'swap_in_tie':
        # a 1-ulp gap, as the nuScenes CenterPoint decode showed it
        got, ref = _candidates(one_ulp)
        traded, worst = tp.assert_candidates_equal(got, ref)
        assert [t[:3] for t in traded] == [(0, 2, 3), (0, 3, 2)]
        assert 0 < worst <= 1
        with pytest.warns(UserWarning, match='stage by stage'):
            tp.assert_single_stage_predict(_predicts(one_ulp), 'pred')
        return
    if case == 'swap_1e-3':
        got, ref = _candidates(1e-3)
        with pytest.raises(AssertionError, match='none of JAX'):
            tp.assert_candidates_equal(got, ref)
        with pytest.raises(AssertionError):
            tp.assert_single_stage_predict(_predicts(1e-3), 'pred')
    elif case == 'box_1e-3':
        got, ref = _candidates(one_ulp)
        got['boxes'][0, 4, 0] += 1e-3
        with pytest.raises(AssertionError):
            tp.assert_candidates_equal(got, ref)
    elif case == 'score_beyond_rounding':
        # within the final slots' atol 1e-4, but not within rounding
        got, ref = _candidates(one_ulp)
        got['scores'][0, 4] += 1e-5
        with pytest.raises(AssertionError, match='beyond rounding'):
            tp.assert_candidates_equal(got, ref)
    elif case == 'fed_flag_flipped':
        with pytest.raises(AssertionError):
            tp.assert_single_stage_predict(_predicts(one_ulp, fed_flip=True),
                                           'pred')
    else:
        # no near tie anywhere: the positional failure stands
        ref, got, _ = _predicts(1e-3)
        ref['candidates']['pred']['scores'][0, 3] = np.float32(0.5)
        with pytest.raises(AssertionError, match='Mismatched'):
            tp.assert_single_stage_predict((ref, got, None), 'pred')


def test_unranked_candidates_compare_slot_by_slot():
    """Candidates in anchor order (scores not ranked) may not trade slots,
    even at equal scores."""
    got, ref = _candidates(0.0)
    for c in (got, ref):
        c['scores'][0] = c['scores'][0, ::-1].copy()
    tp.assert_candidates_equal(ref, ref)
    with pytest.raises(AssertionError, match='differ'):
        tp.assert_candidates_equal(got, ref)


def test_cut_run_takes_a_tied_outsider():
    """The last slot's run: the port's top-k may hold a candidate that JAX
    cut, if it is scored within the bound of JAX's last score, and no
    other."""
    _, ref = _candidates(1e-3)
    got = {k: None if v is None else v.copy() for k, v in ref.items()}
    got['boxes'][0, 5] += 1.0
    tp.assert_candidates_equal(got, ref)
    got['scores'][0, 5] -= np.float32(1e-3)
    with pytest.raises(AssertionError, match='none of JAX'):
        tp.assert_candidates_equal(got, ref)


@pytest.mark.parametrize('lyft', [False, True], ids=['nuscenes', 'lyft'])
def test_tree_batch_is_deterministic(lyft, tmp_path):
    """nuscenes_parity.tree_batch draws its sweeps from a seeded stream:
    two builds over one tree give the same batch bit for bit, and another
    seed draws another one."""
    import nuscenes_parity as npar
    name = 'lyft_second_multihead' if lyft else 'nuscenes_centerpoint'
    root = npar.nusc_tree(tmp_path / 'tree', lyft=lyft, seed=3 if lyft else 1)
    cfg = npar.toy_cfg(name, root)
    first, again, other = (npar.tree_batch(cfg, root, seed=s)
                           for s in (0, 0, 1))
    assert set(first) == set(again)
    for k, v in first.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
        assert again[k].dtype == v.dtype, k
    assert not np.array_equal(other['points'], first['points'])
