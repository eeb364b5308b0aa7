"""glenet_tpu checkpoints and the demo for KITTI's three-class detectors
in the port, on the CPU:

  - a toy checkpoint of each family (SECOND-multihead, SECOND-IoU,
    PointPillars) saved by glenet_tpu.train.checkpoint gives JAX's predict
    through the port's .msgpack reader (integers exactly, floats rtol 1e-4
    / atol 1e-5);
  - `tools.demo --device cpu` writes the JSON records the repository's
    tools/demo.py writes on the same .msgpack and scans (frames and labels
    equal, boxes and scores rtol / atol 1e-4: JSON text of f32 values),
    plus the HTML and PLY exports."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CLASSES = ('Car', 'Pedestrian', 'Cyclist')


def _save_jax_checkpoint(cfg, path, seed):
    """Numpy-drawn variables of `cfg` in a glenet_tpu checkpoint (epoch 3,
    step 12) under `path`; returns (checkpoint path, variables)."""
    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.train import checkpoint as ckpt_lib
    from glenet_tpu.train import optim, state as state_lib
    batch = tp.single_stage_batch(cfg, n_points=1024, seed=8)
    det = jax_build(cfg)
    variables = tp.random_variables(jax.eval_shape(
        det.init, jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch)),
        seed=seed)
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    params = jax.tree.map(jnp.asarray, variables['params'])
    ts = state_lib.TrainState(
        step=jnp.asarray(12, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables['batch_stats']),
        opt_state=tx.init(params))
    return ckpt_lib.save_checkpoint(ckpt_lib.checkpoint_state(ts, 3, 12),
                                    path, 3), variables


@pytest.mark.parametrize('kind', ['MULTIHEAD', 'IOU', 'PILLAR'])
def test_msgpack_reader(kind, tmp_path):
    """The port's reader builds a detector whose predict equals JAX's on
    the saved variables (at zero thresholds, every candidate live)."""
    from glenet_tpu_torch.train import jax_checkpoint
    cfg = tp.zero_thresholds(tp.tiny_single_stage_cfg(kind))
    path, variables = _save_jax_checkpoint(cfg, tmp_path / 'ckpt', 7)
    tdet = jax_checkpoint.build_detector_from_checkpoint(
        tp.to_port_cfg(cfg), path, device='cpu')
    with tp.pinned_f32():
        _, jax_pred, _, pred, _ = tp.run_predicts(cfg, variables=variables,
                                                  tdet=tdet, seed=8)
    for k in ('final_valid', 'final_labels'):
        np.testing.assert_array_equal(pred[k].numpy(), jax_pred[k])
    assert jax_pred['final_valid'].any()
    for k in ('final_boxes', 'final_scores'):
        tp.assert_close(pred[k], jax_pred[k], err_msg=k)


def _write_scans(base, n=2):
    rng = np.random.RandomState(9)
    base.mkdir(parents=True)
    for i in range(n):
        pts = np.stack([rng.uniform(0, 16, 3000), rng.uniform(-8, 8, 3000),
                        rng.uniform(-2.9, 0.9, 3000),
                        rng.uniform(0, 1, 3000)], 1).astype(np.float32)
        pts.tofile(str(base / f'{i:06d}.bin'))
    return base


def test_demo_matches_jax_demo(tmp_path, monkeypatch):
    """Both demos on one toy PointPillars .msgpack (zero thresholds) over 2
    scans cut to 2048 points."""
    from glenet_tpu_torch.tools import demo
    cfg = tp.zero_thresholds(tp.tiny_single_stage_cfg('PILLAR'))
    cfg.DATA_CONFIG.MAX_POINTS_PER_SCENE = 2048
    path, _ = _save_jax_checkpoint(cfg, tmp_path / 'ckpt', 11)
    cfg_file = tmp_path / 'toy_pointpillar.yaml'
    cfg_file.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    scans = _write_scans(tmp_path / 'scans')
    args = ['--cfg_file', str(cfg_file), '--data_path', str(scans),
            '--ckpt', str(path)]
    monkeypatch.syspath_prepend(str(ROOT / 'tools'))
    monkeypatch.setattr(sys, 'argv', ['demo.py', *args, '--output',
                                      str(tmp_path / 'jax.jsonl')])
    import importlib.util
    spec = importlib.util.spec_from_file_location('jax_demo',
                                                  ROOT / 'tools/demo.py')
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)
    with tp.pinned_f32():
        jax_demo.main()
        records = demo.main([*args, '--output', str(tmp_path / 'port.jsonl'),
                             '--html_dir', str(tmp_path / 'html'),
                             '--ply_dir', str(tmp_path / 'ply'),
                             '--device', 'cpu'])
    ref = [json.loads(line) for line in
           (tmp_path / 'jax.jsonl').read_text().splitlines()]
    got = [json.loads(line) for line in
           (tmp_path / 'port.jsonl').read_text().splitlines()]
    assert got == records and len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        assert g['frame'] == r['frame'] and g['labels'] == r['labels']
        assert len(g['labels']) > 0 and set(g['labels']) <= set(CLASSES)
        tp.assert_close(g['boxes_lidar'], r['boxes_lidar'], rtol=1e-4,
                        atol=1e-4)
        tp.assert_close(g['scores'], r['scores'], rtol=1e-4, atol=1e-4)
    assert sorted(p.name for p in (tmp_path / 'html').iterdir()) == [
        '000000.html', '000001.html']
    assert 'const DATA' in (tmp_path / 'html/000000.html').read_text()
    ply = (tmp_path / 'ply/000000.ply').read_text().splitlines()
    assert ply[2] == f'element vertex {2048 + 8 * len(got[0]["labels"])}'
