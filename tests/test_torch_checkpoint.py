"""The port's checkpoints (train/checkpoint.py) on the toy two-stage
GLENet-VR topology, on the CPU: the save / load round trip of parameters,
BN running stats, adam_onecycle's state, step and epoch (bit-exact),
`find_latest_checkpoint` and pruning, and resume equivalence: two train
steps straight give bit-identical parameters and BN stats to one step, a
save, a load into a freshly built detector, and one more step (the step's
RoI-sampling and dropout draws are seeded from the restored step).  The
resume test runs on one CPU thread: with several, the backward's
multithreaded reductions sum in an order that varies from run to run, so
even two straight runs differ in the last bits of some gradients."""
import os

import numpy as np
import pytest
import torch

import torch_parity as tp

B, N_POINTS, N_GT = 2, 1024, 8
TOTAL_STEPS = 10


def _cfg():
    return tp.to_port_cfg(tp.tiny_twostage_cfg(512))


def _batch(cfg, seed):
    """Toy points with three Car gts per sample and label variances."""
    x0, y0, z0, x1, y1, z1 = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, N_POINTS, 4), np.float32)
    pts[..., 0] = rng.uniform(x0, x1, (B, N_POINTS))
    pts[..., 1] = rng.uniform(y0, y1, (B, N_POINTS))
    pts[..., 2] = rng.uniform(z0 + 0.1, z1 - 0.1, (B, N_POINTS))
    pts[..., 3] = rng.uniform(0, 1, (B, N_POINTS))
    gt = np.zeros((B, N_GT, 8), np.float32)
    gt_mask = np.zeros((B, N_GT), bool)
    for b in range(B):
        for g in range(3):
            gt[b, g] = [rng.uniform(x0 + 3, x1 - 3), rng.uniform(y0 + 3, y1 - 3),
                        0.5 * (z0 + z1), 3.9, 1.6, 1.56, rng.uniform(-1, 1), 1]
            gt_mask[b, g] = True
    unc = rng.uniform(0.02, 0.3, (B, N_GT, 7)).astype(np.float32)
    return {'points': torch.from_numpy(pts),
            'points_mask': torch.ones((B, N_POINTS), dtype=torch.bool),
            'gt_boxes': torch.from_numpy(gt),
            'gt_mask': torch.from_numpy(gt_mask),
            'gt_uncertainty': torch.from_numpy(unc)}


def _training(cfg, seed=0):
    from glenet_tpu_torch.train import optim, state as st
    from glenet_tpu_torch.utils.synthetic import seeded_detector
    det = seeded_detector(cfg, 'cpu', seed)
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, TOTAL_STEPS)
    return det, st.create_train_state(det, tx), st.make_train_step(det, tx)


def _assert_same_net(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope='module')
def cfg():
    return _cfg()


def test_round_trip(cfg, tmp_path):
    from glenet_tpu_torch.train import checkpoint as ck
    det, state, step = _training(cfg)
    state, _ = step(state, _batch(cfg, 1))
    path = ck.save_checkpoint(ck.checkpoint_state(state, epoch=3, it=7),
                              tmp_path, epoch=3)
    assert os.path.basename(path) == 'checkpoint_epoch_3.pth'
    loaded = ck.load_checkpoint(path)
    assert (loaded['epoch'], loaded['it'], loaded['step']) == (3, 7, 1)

    # a freshly built detector with other weights takes the checkpoint
    fresh, fstate, _ = _training(cfg, seed=5)
    assert not torch.equal(next(fresh.net.parameters()),
                           next(det.net.parameters()))
    ck.restore_train_state(fstate, loaded)
    _assert_same_net(fresh.net, det.net)
    assert fstate.step == state.step == 1
    for key in ('mu', 'nu'):
        assert len(fstate.opt_state[key]) == len(state.opt_state[key])
        for x, y in zip(fstate.opt_state[key], state.opt_state[key]):
            assert torch.equal(x, y)
    assert fstate.opt_state['count'] == state.opt_state['count'] == 1
    assert fstate.opt_state['hyperparams'] == state.opt_state['hyperparams']
    # the restored moments are the optimizer's own tensors, written in place
    assert fstate.opt_state['mu'][0].data_ptr() != \
        loaded['optimizer_state']['mu'][0].data_ptr()


def test_find_latest_and_prune(tmp_path):
    from glenet_tpu_torch.train import checkpoint as ck
    assert ck.find_latest_checkpoint(tmp_path) is None
    for epoch in (8, 9, 10, 11):
        ck.save_checkpoint({'epoch': epoch, 'w': torch.full((2,), epoch)},
                           tmp_path, epoch, max_ckpt_save_num=3)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ['checkpoint_epoch_10.pth', 'checkpoint_epoch_11.pth',
                     'checkpoint_epoch_9.pth']
    latest = ck.find_latest_checkpoint(tmp_path)
    assert latest.endswith('checkpoint_epoch_11.pth')
    assert int(ck.load_checkpoint(latest)['w'][0]) == 11
    # newest by epoch, not by name or by time
    os.utime(tmp_path / 'checkpoint_epoch_9.pth', (4e9, 4e9))
    assert ck.find_latest_checkpoint(tmp_path).endswith('_11.pth')


def test_checkpoint_holds_no_objects(cfg, tmp_path):
    """weights_only loading: only tensors, numbers, strings and containers
    in a checkpoint."""
    from glenet_tpu_torch.train import checkpoint as ck
    _, state, _ = _training(cfg)
    path = ck.save_checkpoint(ck.checkpoint_state(state, 0, 0), tmp_path, 0)
    raw = torch.load(path, map_location='cpu', weights_only=True)

    def walk(x):
        if isinstance(x, dict):
            return all(isinstance(k, str) and walk(v) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return all(walk(v) for v in x)
        return isinstance(x, (torch.Tensor, int, float, str))

    assert walk(raw)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_equivalence(cfg, tmp_path, one_thread):
    from glenet_tpu_torch.train import checkpoint as ck
    batches = [_batch(cfg, 11), _batch(cfg, 12)]

    straight, s_state, s_step = _training(cfg)
    for b in batches:
        s_state, _ = s_step(s_state, b)

    first, f_state, f_step = _training(cfg)
    f_state, _ = f_step(f_state, batches[0])
    path = ck.save_checkpoint(ck.checkpoint_state(f_state, 0, 1), tmp_path, 0)
    del first, f_state, f_step

    resumed, r_state, r_step = _training(cfg, seed=9)
    ck.restore_train_state(r_state, ck.load_checkpoint(path))
    r_state, _ = r_step(r_state, batches[1])

    assert r_state.step == s_state.step == 2
    _assert_same_net(resumed.net, straight.net)
    for x, y in zip(r_state.opt_state['mu'] + r_state.opt_state['nu'],
                    s_state.opt_state['mu'] + s_state.opt_state['nu']):
        assert torch.equal(x, y)
