"""A cell shrunk to run on the CPU in seconds: the published layers and
widths over a 19.2 m grid, a few thousand points, small budgets."""
from __future__ import annotations

import copy
import json
import shutil
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
RANGE = 9.6


def tiny_config(config):
    c = copy.deepcopy(config)
    d = c['config']['DATA_CONFIG']
    d['POINT_CLOUD_RANGE'] = [-RANGE, -RANGE, -2, RANGE, RANGE, 4]
    for p in d['DATA_PROCESSOR']:
        if p['NAME'] == 'transform_points_to_voxels':
            p['MAX_NUMBER_OF_VOXELS'] = {'train': 1500, 'test': 1500}
    return c


def tiny_traffic(traffic):
    t = dict(traffic, points=3000, pool=4, range=RANGE, vehicles=[2, 4],
             vehicle_radius=[2.0, 7.0], profiled_calls=1)
    if 'checked_requests' in t:
        t['checked_requests'] = 2
    return t


def session(workload, seed=5, seconds=0.0, trace=False, limits=None):
    """The run namespace a driver takes, for the tiny cell on the CPU."""
    from benchmark import harness
    _, _, conf, config, traffic, lims = harness.find_cell(ROOT, workload)
    return types.SimpleNamespace(
        seed=seed, seconds=seconds, trace=trace, t0=0.0,
        config=tiny_config(config), conf=conf, traffic=tiny_traffic(traffic),
        limits=lims if limits is None else limits,
        device=torch.device('cpu'))


def tiny_root(tmp):
    """A checkout-like folder holding BENCHMARK.json and benchmark/ with
    the tiny cells' configuration and traffic files."""
    tmp = Path(tmp)
    shutil.copy(ROOT / 'BENCHMARK.json', tmp / 'BENCHMARK.json')
    shutil.copytree(ROOT / 'benchmark', tmp / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = json.loads((tmp / 'BENCHMARK.json').read_text())
    for conf in bench['configs']:
        path = tmp / conf['file']
        path.write_text(json.dumps(tiny_config(json.loads(
            path.read_text()))))
    for cell in bench['workloads']:
        path = tmp / 'benchmark' / 'traffic' / f"{cell['traffic']}.json"
        path.write_text(json.dumps(tiny_traffic(json.loads(
            path.read_text()))))
    return tmp
