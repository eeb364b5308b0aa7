"""A new configuration, cell and per-layer metric are new files and new
BENCHMARK.json entries, with no edit to a file the harness has."""
import json
import types

import torch

from benchmark import harness, run
from benchmark.tests import tiny


def test_dummy_cell_from_new_files(tmp_path):
    root = tiny.tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / 'benchmark').rglob('*.py')}
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    # a configuration: the CenterPoint file under a new name
    conf = dict(bench['configs'][1], name='dummy_cfg',
                file='benchmark/configs/dummy_cfg.json')
    (root / conf['file']).write_text(
        (root / bench['configs'][1]['file']).read_text())
    # a traffic mix: data only
    traffic = json.loads((root / 'benchmark' / 'traffic'
                          / 'predict_b1.json').read_text())
    traffic['pool'] = 3
    (root / 'benchmark' / 'traffic' / 'dummy_mix.json').write_text(
        json.dumps(traffic))
    (root / 'benchmark' / 'limits' / 'dummy_cfg.dummy_mix.json').write_text(
        json.dumps({'map_gap': 1.0}))
    # a per-layer metric: its reader
    (root / 'benchmark' / 'metrics' / 'dummy_calls.py').write_text(
        'def read(ctx):\n    return float(ctx["plain_calls"])\n')
    bench['configs'].append(conf)
    bench['workloads'].append({'name': 'dummy_cfg.dummy_mix',
                               'config': 'dummy_cfg', 'traffic': 'dummy_mix',
                               'chips': 1, 'why': 'a test'})
    bench['per_layer'].append({'name': 'dummy_calls', 'unit': 'calls',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'test', 'moves':
                               'predict_scans_per_s',
                               'workloads': ['dummy_cfg.dummy_mix']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    cell = harness.find_cell(root, 'dummy_cfg.dummy_mix')[1]
    assert cell['traffic'] == 'dummy_mix'
    args = types.SimpleNamespace(workload='dummy_cfg.dummy_mix', seed=4,
                                 seconds=1.0, trace=1)
    code, line = run.execute(root, args, torch.device('cpu'))
    out = json.loads(line)
    assert code == 0 and out['metrics']['dummy_calls']['value'] >= 1
    assert set(out['checks']) == {'map_gap'}
    assert before == {p: p.read_bytes() for p in before}
