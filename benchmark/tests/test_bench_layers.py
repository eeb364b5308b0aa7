"""Each layer's device and idle time from the program's spans
(benchmark/layers.py), on event lists built by hand and on a profiler
session of a tiny cell; and the program's ranges leave analyse()'s keys as
they were."""
import types

import pytest
import torch

from benchmark import layers, tracing
from benchmark.tests import tiny

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


def ev(name, start, end, device=False, id=0, thread=1, parent=None,
       annotation=False):
    return types.SimpleNamespace(
        name=name, time_range=_Range(start, end), id=id, thread=thread,
        device_type=CUDA if device else CPU, cpu_parent=parent,
        is_user_annotation=annotation)


def training_window():
    """A window of 100 us over one train step: the loss's kernel launched
    from the caller's thread, the backward's from autograd's thread while
    the caller waits in glenet::backward, a copy launched before the
    step, and the device-side annotations of two user-scope ranges."""
    mul = ev('aten::mul', 12, 14)
    back = ev('MulBackward0', 44, 47, thread=2)
    return [
        ev(tracing.WINDOW_RANGE, 0, 100),
        ev(tracing.WINDOW_RANGE, 3, 70, device=True, annotation=True),
        ev('glenet::train_step', 10, 90),
        ev('glenet::loss', 10, 40),
        ev('glenet::backward', 40, 90),
        ev('glenet::loss', 15, 25, device=True, annotation=True),
        mul,
        ev('cudaLaunchKernel', 12, 13, id=101, parent=mul),
        ev('elementwise_kernel', 15, 25, device=True, id=101),
        back,
        ev('cudaLaunchKernel', 45, 46, id=102, thread=2, parent=back),
        ev('elementwise_kernel', 50, 70, device=True, id=102, thread=2),
        ev('cudaMemcpyAsync', 2, 3, id=103),
        ev('Memcpy HtoD (Pinned -> Device)', 3, 8, device=True, id=103),
    ]


def test_layers_assign_by_launch_time_and_split_idle_at_boundaries():
    out = layers.layers(training_window())
    assert out['calls'] == 1 and out['unmatched'] == 0
    ms = 1e-3
    assert out['window_ms'] == pytest.approx(100 * ms)
    # the loss's kernel, the backward's from the second thread, the copy
    # launched outside every span
    assert out['busy_ms'] == pytest.approx(
        {'loss': 10 * ms, 'backward': 20 * ms, 'outside': 5 * ms})
    # idle 25-50 splits at the loss / backward boundary (40); 0-3 and
    # 8-10 lie before the step, 90-100 after it
    assert out['idle_ms'] == pytest.approx(
        {'loss': 20 * ms, 'backward': 30 * ms, 'outside': 15 * ms})
    total = sum(out['busy_ms'].values()) + sum(out['idle_ms'].values())
    assert total == pytest.approx(out['window_ms'])
    assert out['ops']['backward'] == [['MulBackward0', pytest.approx(
        20 * ms)]]


def test_layers_of_a_window_without_program_spans():
    events = [e for e in training_window()
              if not e.name.startswith(layers.PREFIX)]
    assert layers.layers(events) is None


def test_nested_spans_take_the_innermost():
    events = [ev(tracing.WINDOW_RANGE, 0, 50),
              ev('glenet::predict', 0, 50),
              ev('glenet::backbone_3d', 5, 45),
              ev('glenet::nms', 20, 30),
              ev('cudaLaunchKernel', 21, 22, id=7),
              ev('k', 22, 24, device=True, id=7),
              ev('cudaLaunchKernel', 31, 32, id=8),
              ev('k', 32, 40, device=True, id=8)]
    out = layers.layers(events)
    assert out['busy_ms'] == pytest.approx(
        {'nms': 2e-3, 'backbone_3d': 8e-3, 'predict': 0.0})
    assert out['idle_ms'] == pytest.approx(
        {'predict': 10e-3, 'backbone_3d': 22e-3, 'nms': 8e-3})


def test_analyse_keys_stay_with_program_ranges():
    """The program's function-scope ranges are host events only: every key
    of analyse() reads as without them, apart from the idle gap that no
    host op covered, which now bears the span's name."""
    base = [ev(tracing.WINDOW_RANGE, 0, 100),
            ev(tracing.WINDOW_RANGE, 5, 120, device=True, annotation=True),
            ev('aten::mul', 10, 60),
            ev(tracing.MERGE_RANGE, 12, 18),
            ev(tracing.MERGE_RANGE, 20, 35, device=True, annotation=True),
            ev('k1', 20, 50, device=True), ev('k2', 30, 40, device=True),
            ev('k3', 90, 120, device=True)]
    spans = [ev('glenet::predict', 1, 99), ev('glenet::backbone_3d', 2, 70),
             ev('glenet::nms', 70, 98)]
    without = tracing.analyse(base)
    with_spans = tracing.analyse(base + spans)
    for key in ('window_s', 'busy_s', 'device_ops', 'merge_device_s'):
        assert with_spans[key] == without[key]
    gaps = dict(with_spans['idle_gaps'])
    assert sum(gaps.values()) == pytest.approx(
        sum(v for _, v in without['idle_gaps']))
    assert 'no host op' in dict(without['idle_gaps'])
    assert 'no host op' not in gaps and 'glenet::nms' in gaps


def test_layers_of_a_tiny_predict_session():
    """A CPU profiler session of the tiny predict cell: no device work, so
    every layer is idle, and the layers add up to the window."""
    from benchmark.drivers import predict
    h = tiny.session('waymo_centerpoint.predict_b1')
    s = predict.Session(h, h.seed)
    s.call()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.WINDOW_RANGE):
            for _ in range(2):
                s.call()
    out = layers.layers(prof.events())
    assert out['calls'] == 2
    assert set(out['idle_ms']) >= {'voxelize', 'vfe', 'backbone_3d',
                                   'backbone_2d', 'dense_head', 'decode',
                                   'nms', 'outside'}
    assert sum(out['busy_ms'].values()) == 0
    assert sum(out['idle_ms'].values()) == pytest.approx(out['window_ms'])


def test_traced_run_reports_the_program_counters(tmp_path):
    """A traced run of the tiny predict cell on the CPU: the counters of
    its profiler phase reach the readers, per call."""
    import json

    from benchmark import run
    from glenet_tpu_torch.utils import trace
    trace.reset()
    root = tiny.tiny_root(tmp_path)
    args = types.SimpleNamespace(workload='waymo_centerpoint.predict_b1',
                                 seed=2 ** 31 + 13, seconds=1.0, trace=1)
    code, line = run.execute(root, args, torch.device('cpu'))
    assert code == 0
    metrics = json.loads(line)['metrics']
    # voxelize 2, two strided caps, the dense expansion, two NMS corner
    # templates, at least two reads of the keep loop
    assert metrics['host_waits.predict']['value'] >= 9
    assert 0 <= metrics['voxels_dropped_pct.predict']['value'] < 100
    assert 0 <= metrics['sites_dropped_pct.predict']['value'] < 100
    trace.reset()
