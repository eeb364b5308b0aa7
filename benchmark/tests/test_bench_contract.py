"""The run's argument contract, its exit without a card, and the shape of
its last line (a tiny cell on the CPU)."""
import json
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness, run
from benchmark.tests import tiny


def test_arguments():
    a = run.parse(['--workload', 'w', '--seed', str(2 ** 31 + 5),
                   '--seconds', '30', '--trace', '1'])
    assert (a.workload, a.seed, a.seconds, a.trace) == ('w', 2 ** 31 + 5,
                                                         30.0, 1)
    with pytest.raises(SystemExit):
        run.parse(['--workload', 'w', '--seed', '1', '--seconds', '1',
                   '--trace', '2'])


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is here')
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        'waymo_centerpoint.predict_b1', '--seed', '1',
                        '--seconds', '1', '--trace', '0'], cwd=tiny.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ''


def test_only_benchmark_files_no_result(tmp_path):
    """A checkout of BENCHMARK.json and benchmark/ alone gives no result."""
    tiny.tiny_root(tmp_path)
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        'waymo_centerpoint.predict_b1', '--seed', '1',
                        '--seconds', '1', '--trace', '0'], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ''


@pytest.mark.parametrize('workload,trace', [
    ('waymo_centerpoint.predict_b1', 0), ('waymo_centerpoint.predict_b1', 1),
    ('waymo_glenet_s.train_b4', 0)])
def test_last_line(tmp_path, workload, trace, capsys):
    root = tiny.tiny_root(tmp_path)
    args = types.SimpleNamespace(workload=workload, seed=2 ** 31 + 9,
                                 seconds=1.0, trace=trace)
    code, line = run.execute(root, args, torch.device('cpu'))
    assert code == 0
    out = json.loads(line)
    assert list(out)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(out)[-1] == 'checks'
    assert out['attempted'] >= 1
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    cell = {w['name']: w for w in bench['workloads']}[workload]
    section = 'per_layer' if trace else 'end_to_end'
    names = {m['name'] for m in harness.metrics_of(bench, cell, section)}
    if trace:       # on the CPU no kernel runs: the device readers abstain
        assert set(out['metrics']) <= names
        assert {'busy_s', 'window_s'} <= set(out['device'])
        assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
    else:
        assert set(out['metrics']) == names
    for m in out['metrics'].values():
        assert set(m) == {'value', 'unit'}
    limits = json.loads((root / 'benchmark' / 'limits'
                         / f'{workload}.json').read_text())
    assert set(out['checks']) == set(limits)
    err = capsys.readouterr().err.strip().splitlines()
    assert [e.split()[1] for e in err[-len(limits):]] == list(out['checks'])
