"""The port's convergence harness (glenet_tpu_torch/tools/convergence_ap.py,
convergence_waymo.py, stage2_recovery.py) against the repository's JAX
harness (tools/convergence_ap.py, tools/convergence_waymo.py) on the CPU.

(a) the synthetic KITTI and Waymo scenes are bit-identical;
(b) the annotation dicts equal JAX's (floats to 1e-6), and the KITTI and
    Waymo evaluations of fixed detections equal JAX's to 1e-4 AP;
(c) cosine_onecycle_schedule equals optax's at every step to 1e-7
    relative, plus one f32 rounding at the peak's scale (2^-24 x peak);
(d) clip + AdamW over a schedule equals the optax chain over 5 updates;
    with zeroed gradients the parameters only decay;
(e) a whole run_overfit (3 steps, the BN refresh, a 2-step frozen-BN
    tail) on a toy GLENet-S equals JAX's run_overfit from the same
    PRNGKey(0) weights: printed values to 1e-4 relative (or their last
    printed digit), the final loss to 1e-4 relative, parameters within
    the reach of the updates and 1e-6 (+ 1e-6 relative) for 90% of the
    elements, BN stats as tests/test_torch_bn_refresh.py holds them
    (rtol 1e-4 plus the EMA inversion's floor) plus 1e-5 of each tensor's
    largest stat;
(f) the tools write only the port's results file (or --out) and their
    mains raise without a card unless --device cpu.

On (e): the run is at a peak LR of 1e-5.  Adam moves every element by
about the LR whatever its gradient's size, so an element whose f32
gradient differs between the packages (near a ReLU kink, or tiny against
eps) moves differently, and the next steps' gradients inherit that: on
this toy model 59% of the elements stay within 1e-6 after 2 steps at
1e-3, 38% after 3 steps at 1e-4, 99.9998% after 3 steps at 1e-5, where
the BN refresh (whose moments follow the parameters) can be held too.

On (c): XLA's jitted schedule differs from its own op-by-op evaluation by
up to 2.9e-5 relative where cos(pi p) + 1 -> 0 (1-2 f32 ulps of the
cosine), so the port is held to optax's op-by-op values, to which one
rounding of the cosine adds at most 2^-24 x peak.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def jtools():
    """The JAX harness's modules (they import each other through
    sys.path, which is restored after the import)."""
    sys.path.insert(0, str(ROOT / 'tools'))
    try:
        import convergence_ap
        import convergence_waymo
    finally:
        sys.path.remove(str(ROOT / 'tools'))
    return convergence_ap, convergence_waymo


def _assert_scenes_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('seed', list(range(16)) + [1000, 1001, 1002, 1003])
def test_kitti_scenes_bit_identical(jtools, seed):
    from glenet_tpu_torch.tools import convergence_ap as ca
    _assert_scenes_equal(ca.make_scene(seed), jtools[0].make_scene(seed))


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 10_000])
def test_waymo_scenes_bit_identical(jtools, seed):
    from glenet_tpu_torch.tools import convergence_waymo as cw
    _assert_scenes_equal(cw.make_scene(seed), jtools[1].make_scene(seed))


def test_harness_constants(jtools):
    from glenet_tpu_torch.tools import convergence_ap as ca
    from glenet_tpu_torch.tools import convergence_waymo as cw
    jca, jcw = jtools
    for name in ('N_SCENES', 'BATCH', 'MAX_POINTS', 'N_GT'):
        assert getattr(ca, name) == getattr(jca, name), name
        assert getattr(cw, name) == getattr(jcw, name), name
    for k, v in jca.CALIB.items():
        np.testing.assert_array_equal(ca.CALIB[k], v)


def _detections(scenes, seed=5):
    """Fixed detections of `scenes`: each gt jittered (a few far off), one
    false positive per scene, random scores."""
    rng = np.random.RandomState(seed)
    out = []
    for _, gt, gm in scenes:
        boxes = gt[gm][:, :7].astype(np.float32).copy()
        boxes[:, :2] += rng.normal(0, 0.3, (len(boxes), 2))
        boxes[:, 6] += rng.normal(0, 0.2, len(boxes))
        boxes[0, :2] += 3.0
        fp = boxes[-1:].copy()
        fp[:, 1] += 6.0
        boxes = np.concatenate([boxes, fp]).astype(np.float32)
        out.append((boxes, rng.uniform(0.1, 1.0, len(boxes))))
    return out


def test_kitti_annos_and_evaluation(jtools):
    from glenet_tpu.eval import kitti_eval as jeval
    from glenet_tpu.utils.calibration_kitti import Calibration as JCalib

    from glenet_tpu_torch.eval import kitti_eval
    from glenet_tpu_torch.tools import convergence_ap as ca
    from glenet_tpu_torch.utils.calibration_kitti import Calibration
    jca = jtools[0]
    scenes = [ca.make_scene(s) for s in range(4)]
    calib, jcalib = Calibration(ca.CALIB), JCalib(jca.CALIB)
    gt, dt, jgt, jdt = [], [], [], []
    for (_, g, m), (boxes, scores) in zip(scenes, _detections(scenes)):
        gt.append(ca.to_annos(g[m][:, :7], None, calib))
        jgt.append(jca.to_annos(g[m][:, :7], None, jcalib))
        dt.append(ca.to_annos(boxes, scores, calib))
        jdt.append(jca.to_annos(boxes, scores, jcalib))
    dt.append(ca.to_annos(np.zeros((0, 7)), np.zeros(0), calib))
    jdt.append(jca.to_annos(np.zeros((0, 7)), np.zeros(0), jcalib))
    for a, b in zip(gt + dt, jgt + jdt):
        assert sorted(a) == sorted(b)
        for k in b:
            if b[k].dtype.kind in 'fi':
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    gt.append(gt[0])
    jgt.append(jgt[0])
    _, ret = kitti_eval.get_official_eval_result(gt, dt, ['Car'],
                                                 device='cpu')
    _, jret = jeval.get_official_eval_result(jgt, jdt, ['Car'])
    assert 0 < ret['Car_3d/moderate_R40'] < 100
    for k in ('Car_3d/moderate_R40', 'Car_3d/moderate_R11',
              'Car_bev/moderate_R40'):
        assert abs(ret[k] - jret[k]) <= 1e-4, (k, ret[k], jret[k])


def test_waymo_annos_and_evaluation(jtools):
    from glenet_tpu.eval import waymo_eval as jeval

    from glenet_tpu_torch.eval import waymo_eval
    from glenet_tpu_torch.tools import convergence_waymo as cw
    jcw = jtools[1]
    scenes = [cw.make_scene(s) for s in range(4)]
    gt, dt, jgt, jdt = [], [], [], []
    for (_, g, m), (boxes, scores) in zip(scenes, _detections(scenes)):
        n = np.full(m.sum(), 400)
        gt.append(cw.to_waymo_annos(g[m][:, :7], n_points=n))
        jgt.append(jcw.to_waymo_annos(g[m][:, :7], n_points=n))
        dt.append(cw.to_waymo_annos(boxes, scores))
        jdt.append(jcw.to_waymo_annos(boxes, scores))
    for a, b in zip(gt + dt, jgt + jdt):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    _, ret = waymo_eval.waymo_evaluation(dt, gt, ['Vehicle'], device='cpu')
    _, jret = jeval.waymo_evaluation(jdt, jgt, ['Vehicle'])
    assert 0 < ret['OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP'] < 100
    for k, v in jret.items():
        assert abs(ret[k] - v) <= 1e-4, (k, ret[k], v)


@pytest.mark.parametrize('n', [1, 2, 3, 4, 10, 200, 700])
def test_cosine_onecycle_schedule(n):
    """The harness's schedule (length max(n, 4)) at every step and 20 past
    its end, against optax's evaluated op by op."""
    import jax.numpy as jnp
    import optax

    from glenet_tpu_torch.tools import convergence_ap as ca
    peak = 1e-3
    ref = optax.cosine_onecycle_schedule(max(n, 4), peak, pct_start=0.3)
    got = ca.harness_optimizer(n, peak).lr
    for c in range(max(n, 4) + 20):
        want = float(ref(jnp.asarray(c, jnp.int32)))
        assert abs(got(c) - want) <= 1e-7 * abs(want) + 2.0 ** -24 * peak, (
            c, got(c), want)
    assert got(max(n, 4) - 1) > got(max(n, 4) + 5) > 0


def _adamw_draws(seed, shapes=((3, 5), (7,), (2, 3, 4))):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    # global norms ~30, ~0.3, ~3, ~30, ~3: the clip at 10 acts on some
    grads = [[(scale * rng.randn(*s)).astype(np.float32) for s in shapes]
             for scale in (10.0, 0.1, 1.0, 10.0, 1.0)]
    return params, grads


@pytest.mark.parametrize('zeroed', [False, True])
def test_clip_adamw_schedule_matches_optax(zeroed):
    """Clip at 10 + AdamW (decay 0.01) over the one-cycle of 5 steps, 5
    updates, against optax.chain(clip_by_global_norm, adamw(schedule));
    zeroed: the first tensor's gradients are zero (stage_2 recovery's
    frozen stage 1): decayed by prod(1 - lr_t * 0.01), not moved by Adam,
    and the clip's norm counts only the other tensors."""
    import jax.numpy as jnp
    import optax

    from glenet_tpu_torch.tools import convergence_ap as ca
    params, grads = _adamw_draws(0)
    if zeroed:
        for g in grads:
            g[0][...] = 0.0
    peak = 3e-3
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(
        optax.cosine_onecycle_schedule(5, peak, pct_start=0.3),
        weight_decay=0.01))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    norms = []
    for g in grads:
        g = [jnp.asarray(x) for x in g]
        norms.append(float(optax.global_norm(g)))
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    assert min(norms) < 10 < max(norms)

    ttx = ca.harness_optimizer(5, peak)
    tpar = [torch.from_numpy(p.copy()) for p in params]
    tstate = ttx.init(tpar)
    for g, want in zip(grads, norms):
        norm = ttx.update(tpar, [torch.from_numpy(x) for x in g], tstate)
        assert float(norm) == pytest.approx(want, rel=1e-6)
    assert tstate['count'] == 5
    for got, want in zip(tpar, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-9)
    if zeroed:
        decay = np.prod([np.float32(1) - np.float32(ttx.lr(t) * 0.01)
                         for t in range(5)])
        np.testing.assert_allclose(tpar[0].numpy(), params[0] * decay,
                                   rtol=1e-6)
        assert not np.array_equal(tpar[0].numpy(), params[0])


def test_adam_constant_lr_unchanged():
    """With a float LR, Adam reads it as before (the CLIs' optimizer)."""
    from glenet_tpu_torch.train.optim import Adam
    tx = Adam(0.01, 0.05, 1.0)
    assert tx.lr_at(0) == tx.lr_at(123) == 0.01


# ---------------------------------------------------------------------------
# (e) one whole run against JAX's run_overfit
# ---------------------------------------------------------------------------

# the peak LR of the whole-run comparison (see the module docstring)
RUN_PEAK_LR = 1e-5
_PRINTED = re.compile(r'^((?:frozen-bn )?step \d+): (.*)$')


def _printed_values(text):
    """{'step i' / 'frozen-bn step i': {name: value}} of the printed
    lines (the wall-clock seconds left out)."""
    out = {}
    for line in text.splitlines():
        m = _PRINTED.match(line)
        if m:
            out[m.group(1)] = {k: float(v) for k, v in re.findall(
                r'([a-z_0-9]+)=(-?[0-9.]+(?:e-?\d+)?)', m.group(2))}
    return out


def _toy_scenes(cfg):
    """4 scenes (2 batches of 2) of the toy config: points, gt, gt_mask."""
    scenes = []
    for seed in (3, 4):
        b = tp.single_stage_batch(cfg, seed=seed)
        scenes += [(b['points'][k], b['gt_boxes'][k], b['gt_mask'][k])
                   for k in range(2)]
    return scenes


@pytest.fixture(scope='module')
def overfit_runs(jtools):
    """JAX's and the port's run_overfit on the toy GLENet-S, the same
    PRNGKey(0) weights: 3 steps, the BN refresh, a 2-step frozen tail; the
    port's BN stats just before the refresh are kept."""
    import contextlib
    import io

    from glenet_tpu.models.detectors import build_detector as jax_build

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.tools import convergence_ap as ca
    from glenet_tpu_torch.train import bn_refresh
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    jca = jtools[0]
    before = {}
    refresh = bn_refresh.refresh_detector_stats

    def keep_stats(det, batches):
        before.update({k: v.clone()
                       for k, v in bn_refresh.bn_stats(det.net).items()})
        return refresh(det, batches)

    cfg = tp.tiny_single_stage_cfg('S')
    scenes = _toy_scenes(cfg)
    n_pts, n_gt = scenes[0][0].shape[0], scenes[0][1].shape[0]
    with tp.pinned_f32():
        det = jax_build(cfg)
        jb = jca.make_batches(scenes, 2, n_pts, n_gt)
        variables = jax.tree.map(np.asarray, det.init(jax.random.PRNGKey(0),
                                                      jb[0]))
        jout = io.StringIO()
        with contextlib.redirect_stdout(jout):
            params, mstate, jloss, _ = jca.run_overfit(
                det, jb, 3, RUN_PEAK_LR, bn_frozen_tail=2)
        tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
        load_jax_variables(tdet.net, variables)
        tb = ca.make_batches(scenes, 2, n_pts, n_gt, 'cpu')
        tout = io.StringIO()
        with contextlib.redirect_stdout(tout), pytest.MonkeyPatch.context(
                ) as mp:
            mp.setattr(bn_refresh, 'refresh_detector_stats', keep_stats)
            state, tloss, _, _ = ca.run_overfit(tdet, tb, 3, RUN_PEAK_LR,
                                                bn_frozen_tail=2)
    ref = {'params': jax.tree.map(np.asarray, params),
           'batch_stats': jax.tree.map(np.asarray, mstate['batch_stats']),
           'loss': jloss, 'printed': _printed_values(jout.getvalue())}
    got = {'det': tdet, 'state': state, 'loss': tloss,
           'printed': _printed_values(tout.getvalue()),
           'init': variables, 'before_refresh': before}
    return ref, got


def test_run_overfit_printed_losses(overfit_runs):
    ref, got = overfit_runs
    assert list(got['printed']) == list(ref['printed']) == [
        'step 0', 'step 2', 'frozen-bn step 0', 'frozen-bn step 1']
    for step, values in ref['printed'].items():
        assert set(got['printed'][step]) == set(values), step
        for k, v in values.items():
            assert abs(got['printed'][step][k] - v) <= max(1e-4 * abs(v),
                                                          1e-3), (step, k)
    assert got['loss'] == pytest.approx(ref['loss'], rel=1e-4)
    assert got['state'].step == 3 and got['state'].opt_state['count'] == 3


def test_run_overfit_parameters(overfit_runs):
    """Every parameter within the reach of the 5 updates (2 x the summed
    LRs, + 1e-6) of JAX's, 90% of the elements within 1e-6 (+ 1e-6
    relative), and every parameter moved from the init."""
    from glenet_tpu_torch.tools import convergence_ap as ca
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref, got = overfit_runs
    net = got['det'].net
    sched = ca.harness_optimizer(3, RUN_PEAK_LR).lr
    reach = 2 * (sum(sched(t) for t in range(3)) + 0.2 * RUN_PEAK_LR) + 1e-6
    params = dict(net.named_parameters())
    init = jax_tree_to_port(net, got['init']['params'])
    n_tight = 0
    for k, v in jax_tree_to_port(net, ref['params']).items():
        p = params[k].detach().numpy()
        diff = np.abs(p - v)
        assert diff.max() <= reach, (k, diff.max(), reach)
        n_tight += int((diff <= 1e-6 + 1e-6 * np.abs(v)).sum())
        assert not np.array_equal(p, init[k]), k
    assert n_tight > 0.9 * sum(p.numel() for p in params.values())


def test_run_overfit_bn_stats(overfit_runs):
    """The BN stats after the refresh (untouched by the frozen tail):
    rtol 1e-4 plus 2^-22 |stat before the refresh| / momentum (the two f32
    roundings that inverting the EMA multiplies by 1 / momentum) plus 1e-5
    of the tensor's largest |stat| (a mean over batches that cancels to
    near 0 keeps the rounding of its terms, whose size is the tensor's)."""
    from glenet_tpu_torch.models.layers import BN_MOMENTUM
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    ref, got = overfit_runs
    net, before = got['det'].net, got['before_refresh']
    stats = jax_tree_to_port(net, ref['batch_stats'], 'batch_stats')
    live = dict(net.named_buffers())
    assert set(stats) == set(before) and stats
    for k, v in stats.items():
        floor = 2.0 ** -22 * np.abs(before[k].numpy()) / BN_MOMENTUM
        err = np.abs(live[k].numpy() - v)
        tol = 1e-4 * np.abs(v) + floor + 1e-5 * np.abs(v).max()
        assert (err <= tol).all(), (k, err.max())
        assert not torch.equal(live[k], before[k]), k


# ---------------------------------------------------------------------------
# (f) what the tools write, and their device
# ---------------------------------------------------------------------------

def _write_yaml(cfg, path):
    import json

    import yaml
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return path


def _watched():
    return {p: (p.stat().st_mtime_ns, p.read_bytes()) if p.exists() else None
            for p in (ROOT / 'CONVERGENCE_AP.json',
                      ROOT / 'CONVERGENCE_AP_TORCH.json')}


def test_tools_write_only_their_results(tmp_path, monkeypatch):
    """On a toy two-stage config (named GLENet_VR.yaml) and a toy Waymo
    GLENet-S, at 2 scenes: convergence_ap writes '<model>_holdout' to
    --out and its checkpoint to <tempdir>/conv_torch_GLENet_VR/,
    stage2_recovery reads that checkpoint and appends its key, and
    convergence_waymo '<model>_waymo'; the repository's results files are
    untouched."""
    import json
    import tempfile

    from glenet_tpu_torch.tools import convergence_ap as ca
    from glenet_tpu_torch.tools import convergence_waymo as cw
    from glenet_tpu_torch.tools import stage2_recovery as s2
    assert ca.RESULTS == ROOT / 'CONVERGENCE_AP_TORCH.json'
    before = _watched()
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path / 'tmp'))
    (tmp_path / 'tmp').mkdir()
    for mod in (ca, cw):
        monkeypatch.setattr(mod, 'N_SCENES', 2)
    vr = tp.tiny_twostage_cfg()
    vr.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -8, -3, 16, 8, 1]
    yaml_vr = _write_yaml(vr, tmp_path / 'GLENet_VR.yaml')
    out = tmp_path / 'results.json'
    ca.main(['2', '1e-3', str(yaml_vr), '512', '2', '--device', 'cpu',
             '--out', str(out)])
    assert sorted(json.loads(out.read_text())) == ['GLENet_VR_holdout']
    dump = tmp_path / 'tmp' / 'conv_torch_GLENet_VR'
    assert sorted(p.name for p in dump.iterdir()) == [
        'annos.pkl', 'checkpoint_epoch_1.pth']

    monkeypatch.setattr(s2, 'MODEL_YAML', str(yaml_vr))
    entry, det = s2.main(['2', '1e-3', '--device', 'cpu', '--out',
                          str(out)])
    assert entry['n_steps'] == 2 and entry['device'] == 'cpu'

    w = tp.tiny_single_stage_cfg('S')
    w.DATA_CONFIG.POINT_FEATURE_ENCODING = {
        'encoding_type': 'absolute_coordinates_encoding',
        'used_feature_list': ['x', 'y', 'z', 'intensity', 'elongation'],
        'src_feature_list': ['x', 'y', 'z', 'intensity', 'elongation']}
    w.CLASS_NAMES = ['Vehicle']
    w.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0].class_name = 'Vehicle'
    yaml_w = _write_yaml(w, tmp_path / 'GLENet_S.yaml')
    cw.main(['2', '1e-3', str(yaml_w), '1', '--device', 'cpu', '--out',
             str(out)])
    results = json.loads(out.read_text())
    assert sorted(results) == ['GLENet_S_waymo', 'GLENet_VR_holdout',
                               'GLENet_VR_stage2_recovery']
    assert results['GLENet_S_waymo']['bn_frozen_tail'] == 1
    assert all(r['device'] == 'cpu' for r in results.values())
    assert _watched() == before


@pytest.mark.parametrize('tool', ['convergence_ap', 'convergence_waymo',
                                  'stage2_recovery'])
def test_tools_need_a_card(tool, tmp_path, monkeypatch):
    """Without --device cpu each tool's main raises before it writes."""
    import importlib
    import tempfile
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: nothing to refuse')
    mod = importlib.import_module(f'glenet_tpu_torch.tools.{tool}')
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    out = tmp_path / 'results.json'
    argv = (['1', '1e-3', 'configs/waymo_models/GLENet_S.yaml']
            if tool == 'convergence_waymo' else ['1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main(argv + ['--out', str(out)])
    assert not any(tmp_path.iterdir())
