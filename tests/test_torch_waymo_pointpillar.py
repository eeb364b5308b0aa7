"""Parity of the port's PointPillars on Waymo (configs/waymo_models/
pointpillar_1x.yaml: PillarVFE with 5 point features and USE_NORM,
PointPillarScatter, a stride-1 BaseBEVBackbone of 3 / 5 / 5 layers,
AnchorHeadSingle with Vehicle, Pedestrian and Cyclist anchors at
feature_map_stride 1, greedy nms_gpu) with glenet_tpu, on the yaml
shrunk as tests/test_waymo_models.py::tiny_waymo_cfg shrinks it: a
38.4 m range (120 x 120 pillars of 0.32 m), 2000 pillars, pre / post NMS
256 / 64.

Same numpy-drawn weights and points, f32 on both sides: the pillar
tables, the pillar features, the canvas and the 2D backbone's map; a
predict at the config's thresholds and one at zero thresholds; the anchor
targets; one train step (every loss term, every gradient, the BN running
stats, the parameters after adam_onecycle).

Tolerances as tests/test_torch_pointpillar.py: integers exactly (pillar
coords, masks and counts, target labels, final labels and valid flags);
floats rtol 1e-4 / atol 1e-5; gradients per tensor max |diff| <= 2e-4
max |grad| + 1e-6; parameters after the step as
tests/test_torch_train_step.py.  Two things of this config's scale, both
f32 rounding:
  - the train forward puts ReLU inputs within f32 rounding of 0 (46 of
    them), whose masks flip between the packages and move whole BN
    channels' gradients; the port's step takes JAX's side at exactly those
    elements, each within 1e-5 of its module's largest |output|
    (torch_parity.align_relu_kinks fails on any larger flip), as
    tests/test_torch_waymo_glenet_s.py does;
  - a BN scale's or bias's gradient sums one term per position of a 2 x
    120 x 120 canvas (per point of 2000 pillars in the VFE), so its f32
    sum carries rounding of order sqrt(N) 2^-24 sum |term|; each such
    channel is held to that on top of the 2e-4 bound (the terms are
    measured on the port's side: dL/dy, and dL/dy x_hat for the scale)."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def test_yaml_builds():
    """pointpillar_1x.yaml builds at full width on the CPU: 468 x 468 x 1
    pillars of 0.32 m, at most 20 points each, a 150000-pillar budget, two
    PFN layers, 3 classes x 2 rotations of anchors at every cell of the 468 x
    468 map (1.31 M per scene)."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector
    det = build_detector(cfg_from_yaml_file(
        str(ROOT / 'configs/waymo_models/pointpillar_1x.yaml')),
        device='cpu')
    assert det.grid_size == (468, 468, 1)
    assert det.max_points_per_voxel == 20
    assert det.max_voxels_train == det.max_voxels_test == 150000
    assert det.num_point_features == 5
    assert det.net.backbone_3d is None
    # two PFN layers: 5 point features + 3 cluster + 3 centre offsets into
    # half of 64 (the first layer's output is concatenated with its max)
    assert det.net.vfe.PFNLayer_0.Dense_0.weight.shape == (32, 11)
    assert det.net.vfe.PFNLayer_1.Dense_0.weight.shape == (64, 64)
    assert det.anchor_set.anchors.shape[:3] == (468, 468, 6)
    assert det.anchor_set.anchors.size == 468 * 468 * 6 * 7


def _bn_term_sums(mp):
    """Patch MaskedBatchNorm so that each train-mode call adds, per channel,
    sum |dL/dy| ('bias') and sum |dL/dy x_hat| ('weight') of its output
    and the number of summed terms ('n') to the returned dict, keyed by
    module."""
    from glenet_tpu_torch.models import layers
    sums = {}
    forward = layers.MaskedBatchNorm.forward

    def counted(self, x, mask=None, use_running_average=True):
        y = forward(self, x, mask, use_running_average)
        if y.requires_grad:
            cdim = self.channel_dim % y.dim()
            axes = [d for d in range(y.dim()) if d != cdim]
            shape = [1] * y.dim()
            shape[cdim] = -1
            x_hat = ((y - self.bias.reshape(shape)) / self.weight.reshape(
                shape)).detach()

            def hook(g, m=self):
                acc = sums.setdefault(m, {'bias': 0, 'weight': 0, 'n': 0})
                acc['bias'] = acc['bias'] + g.abs().sum(axes)
                acc['weight'] = acc['weight'] + (g * x_hat).abs().sum(axes)
                acc['n'] += y.numel() // y.shape[cdim]
            y.register_hook(hook)
        return y

    mp.setattr(layers.MaskedBatchNorm, 'forward', counted)
    return sums


@pytest.fixture(scope='module')
def runs():
    from test_waymo_models import tiny_waymo_cfg
    cfg = tiny_waymo_cfg('pointpillar_1x.yaml')
    batch = tp.single_stage_batch(cfg)
    with tp.pinned_f32():
        predicts = tp.run_single_stage_predicts(cfg, batch)
        with pytest.MonkeyPatch.context() as mp:
            sums = _bn_term_sums(mp)
            step = tp.run_single_stage_step(cfg, batch, align_relu=True)
    return cfg, batch, predicts, step, sums


def test_stages(runs):
    """Pillars of 5-feature points, some full and some of one point; the
    pillar features, the canvas and the 2D backbone's map."""
    _, batch, predicts, _, _ = runs
    assert batch['points'].shape[-1] == 5
    counts = predicts[0]['stages']['vox']['voxel_num_points']
    mask = predicts[0]['stages']['vox']['voxel_mask']
    assert mask.any() and (counts[mask] == 1).any() and counts.max() > 1
    tp.assert_single_stage_stages(predicts)


@pytest.mark.parametrize('key', ['pred', 'pred_zero'])
def test_predict(runs, key):
    ref, got, _ = runs[2]
    for k in ('final_valid', 'final_labels'):
        np.testing.assert_array_equal(got[key][k].numpy(), ref[key][k])
    for k in ('final_boxes', 'final_scores'):
        tp.assert_close(got[key][k], ref[key][k], err_msg=k)
    if key == 'pred_zero':
        assert ref[key]['final_valid'].all()


def test_targets(runs):
    tp.assert_single_stage_targets(runs[3])


def test_loss_terms(runs):
    ref, metrics, _, _, _ = runs[3]
    tp.assert_loss_terms_equal(metrics, ref['metrics'])


def test_gradients(runs):
    """Every gradient within 2e-4 of its tensor's largest |gradient| (+1e-6),
    a BN scale's or bias's channel also within the rounding of its sum."""
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref, _, grads, _, tdet = runs[3]
    assert 'vfe.PFNLayer_0.Dense_0.weight' in grads
    assert 0 < ref['relu_flipped'] <= 100, ref['relu_flipped']
    modules = dict(tdet.net.named_modules())
    sums = runs[4]
    ref_grads = jax_tree_to_port(tdet.net, ref['grads'])
    assert set(ref_grads) == set(grads)
    for k, g_ref in ref_grads.items():
        tol = 2e-4 * np.abs(g_ref).max() + 1e-6
        owner, leaf = k.rsplit('.', 1)
        if modules[owner] in sums:
            acc = sums[modules[owner]]
            tol = tol + np.sqrt(acc['n']) * 2.0 ** -24 * acc[leaf].numpy()
        err = np.abs(grads[k].numpy() - g_ref)
        assert (err <= tol).all(), (k, err.max(), np.max(tol))


def test_bn_stats(runs):
    ref, _, _, _, tdet = runs[3]
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])


def test_params_after_adam(runs):
    cfg, _, _, step, _ = runs
    ref, _, grads, _, tdet = step
    opt = cfg.OPTIMIZATION
    tp.assert_params_after_adam(tdet, ref, grads,
                                float(opt.LR) / float(opt.DIV_FACTOR))
