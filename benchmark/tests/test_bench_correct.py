"""`correct` comes out false for each fault a cell can have, and for the
control: a run on the CPU (a tiny cell, the chip look skipped) with the
timed path broken underneath, and on the card the control at the cell's
own size."""
import json
import types

import pytest
import torch

from benchmark import control, harness, run
from benchmark.tests import tiny

FAULTS = [('waymo_glenet_s.train_b4', 'unchanged'),
          ('waymo_glenet_s.train_b4', 'half_batch'),
          ('waymo_glenet_s.train_b4', 'loss_sign'),
          ('waymo_glenet_s.train_b4', 'loss_scale'),
          ('waymo_centerpoint.predict_b1', 'altered'),
          ('waymo_centerpoint.predict_b1', 'skip_nms')]


@pytest.mark.parametrize('workload,fault', FAULTS)
def test_fault_is_not_correct(tmp_path, workload, fault):
    root = tiny.tiny_root(tmp_path)
    kind = 'train' if 'train' in workload else 'predict'
    args = types.SimpleNamespace(workload=workload, seed=2 ** 31 + 11,
                                 seconds=0.5, trace=0)
    with control.FAULTS[kind][fault]():
        code, line = run.execute(root, args, torch.device('cpu'))
    assert code == 0 and json.loads(line)['correct'] is False


@pytest.mark.card
@pytest.mark.parametrize('workload', ['waymo_glenet_s.train_b4',
                                      'waymo_centerpoint.predict_b1'])
def test_control_is_not_correct_on_card(workload):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the control runs at the cell\'s '
                    'own size')
    _, _, conf, config, traffic, limits = harness.find_cell(tiny.ROOT,
                                                           workload)
    h = types.SimpleNamespace(config=config, conf=conf, traffic=traffic,
                              limits=limits, device=torch.device('cuda', 0))
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        assert harness.checks_of(control.readings(h, seed, 'program'),
                                 limits)[1]
        assert not harness.checks_of(control.readings(h, seed, 'control'),
                                     limits)[1]
