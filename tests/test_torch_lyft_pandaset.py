"""Parity of the port's Lyft and Pandaset pieces (glenet_tpu_torch/
datasets/{lyft_dataset, pandaset_raw, pandaset_dataset}.py) with
glenet_tpu's, on the CPU:

  - Lyft items over one synthetic tree (5 sweeps, Lyft's gt database),
    both datasets' RandomStates set to one seeded state: training and test
    batches, integers and masks exactly, floats bit for bit;
  - the Lyft mAP dict on the same detections to 1e-6.  Each detection is a
    gt scaled about its centre by f in {0.80, 0.86, 0.92, 0.985}, so its 3D
    IoU with that gt is f^3 (0.512, 0.636, 0.779, 0.956), at least 0.006
    from every threshold 0.5, 0.55, ..., 0.95; its IoU with any other gt is
    0 (the tree's boxes do not overlap), and the test checks on the port's
    IoUs that none lies within 1e-4 of a threshold, so f32 rounding cannot
    move a match between the packages;
  - the pandaset_raw geometry on seeded poses, atol 1e-6;
  - Pandaset items (the points padded to 5 columns, gt sampling of the
    tree's 5-feature crops) as Lyft's, and the KITTI-format AP dict on the
    same detections to 1e-6, the scale factors {0.6, 0.75, 0.85, 0.95}
    putting BEV and 3D IoUs at least 0.02 from 0.25, 0.5 and 0.7;
  - the slice: a toy SECOND-multihead with the sin/cos coder (the Lyft
    run-time config cut to size, nuscenes_parity.toy_cfg) over a tiny Lyft
    tree, weights through utils/jax_weights: the backbone's stages, a
    predict at the config's thresholds and at zero thresholds, the
    8-code anchor targets, every loss term, every gradient and the BN
    stats after one train step, at torch_parity's tolerances (integers
    exactly; floats rtol 1e-4 / atol 1e-5, final boxes and scores atol
    1e-4; gradients per tensor 2e-4 of the largest |grad| + 1e-6)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

from glenet_tpu.datasets import pandaset_raw as jpr  # noqa: E402

import nuscenes_parity as npar  # noqa: E402
from glenet_tpu_torch.datasets import pandaset_raw as tpr  # noqa: E402

LYFT = 'lyft_second_multihead'
PANDASET = 'pandaset_second'


@pytest.fixture(scope='module')
def lyft_tree(tmp_path_factory):
    return npar.nusc_tree(tmp_path_factory.mktemp('lyft') / 'lyft',
                          lyft=True)


@pytest.fixture(scope='module')
def pandaset_tree(tmp_path_factory):
    return npar.pandaset_tree(tmp_path_factory.mktemp('panda') / 'pandaset')


def _assert_batches_equal(jds, tds, seed=3):
    n_gt = 0
    for ref, got in zip(jds.iter_batches(2, seed=seed),
                        tds.iter_batches(2, seed=seed)):
        assert set(got) == set(ref)
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
        n_gt += int(ref['gt_mask'].sum())
    return n_gt


@pytest.mark.parametrize('training', [True, False])
def test_lyft_items(lyft_tree, training):
    jds, tds = npar.dataset_pair(npar.data_dict(LYFT, lyft_tree),
                                 list(npar.LYFT_TOY_CLASSES), training)
    assert type(tds).__name__ == 'LyftDataset' and tds.METRIC == 'Lyft'
    assert _assert_batches_equal(jds, tds) > 8


def _scaled(gt_annos, factors, seed):
    """Each gt scaled about its centre by a factor of `factors` (cycling),
    scores in (0.2, 1), plus one false positive 25 m from the first box."""
    rng = np.random.RandomState(seed)
    dets = []
    for gt in gt_annos:
        b = np.asarray(gt['boxes_lidar'])[:, :7].astype(np.float32)
        f = np.resize(np.asarray(factors, np.float32), len(b))
        b[:, 3:6] *= f[:, None]
        fp = b[:1].copy()
        fp[:, :2] += 25.0
        names = np.concatenate([gt['name'], gt['name'][:1]])
        dets.append({'name': names, 'boxes_lidar': np.concatenate([b, fp]),
                     'score': rng.uniform(0.2, 1.0, len(names)).astype(
                         np.float32)})
    return dets


def test_lyft_evaluation(lyft_tree):
    from glenet_tpu_torch.datasets.lyft_dataset import IOU_THRESHOLDS
    from glenet_tpu_torch.ops import iou3d
    names = list(npar.LYFT_TOY_CLASSES)
    jds, tds = npar.dataset_pair(npar.data_dict(LYFT, lyft_tree), names,
                                 training=False)
    np.testing.assert_array_equal(
        IOU_THRESHOLDS, np.arange(0.5, 0.951, 0.05))
    dets = _scaled(tds.gt_annos(), (0.80, 0.86, 0.92, 0.985), 6)
    for d, g in zip(dets, tds.gt_annos()):
        iou = iou3d.boxes_iou3d(
            torch.from_numpy(d['boxes_lidar']),
            torch.from_numpy(np.asarray(g['boxes_lidar'])[:, :7]
                             .astype(np.float32))).numpy()
        near = np.abs(iou[..., None] - IOU_THRESHOLDS).min(-1)
        assert near[iou > 0].min() > 1e-4
    _, ref = jds.evaluation(dets, names)
    _, got = tds.evaluation(dets, names, device='cpu')
    assert set(got) == set(ref) == {f'{c}_mAP' for c in names} | {'mAP'}
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert 20 < got['mAP'] < 100


def _pose(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    return {'position': dict(zip('xyz', rng.uniform(-50, 50, 3))),
            'heading': dict(zip('wxyz', q))}


@pytest.mark.parametrize('seed', [0, 1])
def test_pandaset_geometry(seed):
    rng = np.random.RandomState(seed)
    pose = _pose(rng)
    pts, inten = rng.uniform(-80, 80, (50, 3)), rng.uniform(0, 1, 50)
    np.testing.assert_allclose(tpr.world_to_ego(pts, pose),
                               jpr.world_to_ego(pts, pose), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tpr.ego_to_normative(pts),
                               jpr.ego_to_normative(pts), rtol=0, atol=0)
    assert abs(tpr.zrot_world_to_ego(pose)
               - jpr.zrot_world_to_ego(pose)) <= 1e-6
    got = tpr.points_to_normative(pts, inten, pose)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jpr.points_to_normative(pts, inten, pose),
                               rtol=0, atol=1e-6)
    args = (pts[:7], rng.uniform(0.5, 5, (7, 3)), rng.uniform(-3, 3, 7),
            pose)
    (b, z), (rb, rz) = tpr.cuboids_to_normative(*args), \
        jpr.cuboids_to_normative(*args)
    np.testing.assert_allclose(b, rb, rtol=0, atol=1e-6)
    assert abs(z - rz) <= 1e-6
    assert tpr.build_sequence_infos('/d', '001', 3) == \
        jpr.build_sequence_infos('/d', '001', 3)
    with pytest.raises(RuntimeError) as ref:
        jpr.create_pandaset_infos('/d', '/d')
    with pytest.raises(RuntimeError) as got:
        tpr.create_pandaset_infos('/d', '/d')
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize('training', [True, False])
def test_pandaset_items(pandaset_tree, training):
    jds, tds = npar.dataset_pair(npar.data_dict(PANDASET, pandaset_tree),
                                 ['Car', 'Pedestrian', 'Cyclist'], training)
    assert type(tds).__name__ == 'PandasetDataset'
    assert tds.get_lidar_with_sweeps(0).shape[1] == 5
    assert _assert_batches_equal(jds, tds) > 8


def test_pandaset_evaluation(pandaset_tree):
    names = ['Car', 'Pedestrian', 'Cyclist']
    jds, tds = npar.dataset_pair(npar.data_dict(PANDASET, pandaset_tree),
                                 names, training=False)
    gts = [{'name': np.asarray(i['gt_names']),
            'boxes_lidar': np.asarray(i['gt_boxes'])} for i in tds.infos]
    dets = _scaled(gts, (0.6, 0.75, 0.85, 0.95), 8)
    _, ref = jds.evaluation(dets, names)
    _, got = tds.evaluation(dets, names, device='cpu')
    assert set(got) == set(ref) and 'Car_3d/moderate_R40' in got
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert got['Car_bev/moderate_R40'] > 0


# ---------------------------------------------------------------------------
# the toy SECOND-multihead with the sin/cos coder over a tiny Lyft tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def lyft_slice(tmp_path_factory):
    """nuscenes_parity.toy_cfg of the Lyft run-time config (sin/cos coder,
    code size 8, car / pedestrian / bicycle heads) over a tiny Lyft tree
    whose anchors keep torch_parity.assert_assigner_margin's 1e-3 from the
    matching thresholds (seed 3; seeds 1, 4 and 6 put a car anchor within
    it), 2 val frames through glenet_tpu's dataset (their sweeps drawn
    from seed 0); both packages'
    predicts and one train step, f32 pinned, the port taking JAX's side
    of each ReLU kink within rounding of 0 (align_relu_kinks), as the
    CenterPoint slice does."""
    import torch_parity as tp
    root = npar.nusc_tree(tmp_path_factory.mktemp('lyft_model') / 'lyft',
                          lyft=True, seed=3)
    cfg = npar.toy_cfg(LYFT, root)
    batch = npar.tree_batch(cfg, root)
    with tp.pinned_f32():
        predicts = tp.run_single_stage_predicts(cfg, batch)
        step = tp.run_single_stage_step(cfg, batch, align_relu=True)
    return cfg, batch, predicts, step


def test_lyft_slice_predict(lyft_slice):
    import torch_parity as tp
    _, batch, predicts, _ = lyft_slice
    assert batch['points'].shape == (2, 4096, 5)
    net = predicts[1]['net']
    assert net.dense_head.head0_conv_box.weight.shape[0] == 2 * 8
    tp.assert_single_stage_stages(predicts)
    for key in ('pred', 'pred_zero'):
        tp.assert_single_stage_predict(predicts, key)
    assert predicts[0]['pred_zero']['final_valid'].sum() > 20


def test_lyft_slice_targets(lyft_slice):
    """The anchor targets in the 8 codes of the sin/cos coder."""
    import torch_parity as tp
    ref, _, _, targets, _ = lyft_slice[3]
    assert targets['box_reg_targets'].shape[-1] == 8
    tp.assert_single_stage_targets(lyft_slice[3])


def test_lyft_slice_loss(lyft_slice):
    """Every loss term (the direction targets from the cos-difference slot,
    as glenet_tpu reads it), every gradient and the BN stats."""
    import torch_parity as tp
    ref, metrics, grads, _, tdet = lyft_slice[3]
    assert {'loss_cls', 'loss_loc', 'loss_dir'} <= set(metrics)
    tp.assert_loss_terms_equal(metrics, ref['metrics'])
    tp.assert_grads_equal(grads, ref['grads'], tdet)
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])
    assert ref['relu_flipped'] <= 8, ref['relu_flipped']
