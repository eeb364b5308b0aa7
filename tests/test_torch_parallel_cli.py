"""The train CLI across 2 gloo processes on the CPU (--device cpu
--coordinator_address --num_processes --process_id) on
test_torch_train_cli.py's toy GLENet-VR tree: 1 epoch x 2 steps of the
B = 2 global batch (B = 1 a rank) with --bn_refresh 1 and
--eval_after_train.  Each rank logs to its own train_rank<R>.log; rank 0
alone writes the checkpoints and result.pkl, whose prediction dicts are
the val frames in dataset order; a one-process run resumes from the
checkpoint."""
import os
import pickle
import subprocess
import sys

import pytest
import torch

from test_torch_train_cli import ROOT, tree  # noqa: F401
from torch_dist import free_port


def _launch(cfg_path, out, world):
    coord = f'127.0.0.1:{free_port()}'
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'glenet_tpu_torch.tools.train',
         '--cfg_file', str(cfg_path), '--output_dir', str(out),
         '--epochs', '1', '--max_steps_per_epoch', '2', '--batch_size', '1',
         '--bn_refresh', '1', '--eval_after_train', '--device', 'cpu',
         '--coordinator_address', coord, '--num_processes', str(world),
         '--process_id', str(r), '--dist_timeout', '300'],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} failed:\n{o[-6000:]}'


@pytest.fixture(scope='module')
def two_process_run(tree, tmp_path_factory):  # noqa: F811
    _, cfg_path = tree
    out = tmp_path_factory.mktemp('two_process') / 'out'
    _launch(cfg_path, out, 2)
    return cfg_path, out


def test_rank_logs_and_rank0_outputs(two_process_run):
    from glenet_tpu_torch.train import checkpoint as ck
    _, out = two_process_run
    assert sorted(p.name for p in out.glob('*.log')) == [
        'train_rank0.log', 'train_rank1.log']
    for r in (0, 1):
        text = (out / f'train_rank{r}.log').read_text()
        assert f'rank {r} of 2, batch 1 per rank, 2 steps/epoch' in text
        assert 'BN stats refreshed over 1 batches' in text
    ckpts = sorted((out / 'ckpt').glob(ck.PATTERN))
    assert [p.name for p in ckpts] == ['checkpoint_epoch_0.pth']
    state = ck.load_checkpoint(ckpts[0])
    assert state['step'] == 2 and state['it'] == 2
    assert all(torch.isfinite(v).all() for v in
               state['model_state'].values() if v.is_floating_point())
    # tensorboard scalars from rank 0 only: one record per logged step
    lines = (out / 'tensorboard' / 'scalars.jsonl').read_text().splitlines()
    assert sum('"train/loss"' in line for line in lines) == 1


def test_eval_merges_ranks_in_dataset_order(two_process_run):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets import build_dataset
    cfg_path, out = two_process_run
    cfg = cfg_from_yaml_file(str(cfg_path))
    ds = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False)
    with open(out / 'eval' / 'result.pkl', 'rb') as f:
        annos = pickle.load(f)
    assert [a['frame_id'] for a in annos] == [
        info['point_cloud']['lidar_idx'] for info in ds.kitti_infos]
    for r in (0, 1):
        assert 'recall@' in (out / f'train_rank{r}.log').read_text()


def test_one_process_resume(two_process_run):
    from glenet_tpu_torch.tools import train
    cfg_path, out = two_process_run
    run = train.main(['--cfg_file', str(cfg_path), '--output_dir', str(out),
                      '--epochs', '2', '--max_steps_per_epoch', '1',
                      '--batch_size', '2', '--device', 'cpu'])
    assert run['start_step'] == 2
    assert [s['it'] for s in run['steps']] == [3]
