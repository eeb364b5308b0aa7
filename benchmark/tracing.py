"""Spans and the profiler window of a traced run.

Spans: the method of `glenet_tpu_torch/profile_predict.py` and
`profile_train.py` (frozen here): forward pre- and post-hooks on the
program's modules, and wrappers around its functions, that synchronise the
device and read the host clock at each layer boundary.  The synchronise
makes the stages add up to more than a call, so spans are taken only in
traced runs, in a phase of their own.

The profiler window: one `torch.profiler` session over a run of calls.
The device is busy where the union of its kernel and copy intervals covers
the window; overlapping kernels count once (the originals summed kernel
times, which counts an overlap twice).  The breakdown names the device
operations that took most time, and the idle gaps by the innermost host
operation running at each gap's middle.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

WINDOW_RANGE = 'bench::window'
MERGE_RANGE = 'bench::merge_resolve'


class Spans:
    """Marks at layer boundaries (device synchronised), one list of
    (name, host time) per call."""

    def __init__(self, device):
        self.device = device
        self.calls = []
        self._handles = []
        self._undo = []

    def mark(self, name):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.calls[-1].append((name, time.perf_counter()))

    def start_call(self):
        self.calls.append([])
        self.mark('start')

    def hook_module(self, module, name):
        self._handles.append(module.register_forward_pre_hook(
            lambda *_: self.mark(f'{name}>')))
        self._handles.append(module.register_forward_hook(
            lambda *_: self.mark(f'{name}<')))

    def wrap(self, owner, attr, name):
        """Mark `name<` when owner.attr returns."""
        real = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            out = real(*args, **kwargs)
            self.mark(f'{name}<')
            return out

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, real))

    def remove(self):
        for h in self._handles:
            h.remove()
        for u in self._undo:
            u()
        self._handles, self._undo = [], []

    def durations(self, pairs):
        """{span: [ms per call]} for spans given as {span: (from, to)},
        over the calls that passed both marks."""
        out = collections.defaultdict(list)
        for call in self.calls:
            t = dict(call)
            for span, (a, b) in pairs.items():
                if a in t and b in t:
                    out[span].append(1e3 * (t[b] - t[a]))
        return dict(out)


@contextlib.contextmanager
def merge_ranges(merge_module, log):
    """Wrap the program's merge-resolve entry in a `record_function` range
    and log the bytes of each call's contract: each `ids` and `queries`
    byte read once, each output byte written once."""
    real = merge_module.resolve_sorted_queries

    def wrapped(ids, queries):
        log.append(contract_bytes(ids.shape, queries.shape))
        with torch.profiler.record_function(MERGE_RANGE):
            return real(ids, queries)

    merge_module.resolve_sorted_queries = wrapped
    try:
        yield
    finally:
        merge_module.resolve_sorted_queries = real


def contract_bytes(ids_shape, queries_shape):
    """Bytes of one merge-resolve call (`glenet_tpu_torch/bench_merge.py`
    `merge_bound`, frozen): int32 ids (B, V) and queries (B, G, Vq) read,
    four int32 (B, G, Vq) outputs written."""
    b, v = ids_shape
    n_q = 1
    for s in queries_shape:
        n_q *= s
    return 4 * (b * v + n_q + 4 * n_q)


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, end_max = 0.0, None
    for a, b in sorted(intervals):
        if end_max is None or a > end_max:
            total += b - a
            end_max = b
        elif b > end_max:
            total += b - end_max
            end_max = b
    return total


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _is_device(ev):
    return ev.device_type != torch.autograd.DeviceType.CPU


def _overlap(intervals, ranges):
    """Length of the union of `intervals` inside the union of `ranges`."""
    total, r = 0.0, merged(ranges)
    for a, b in merged(intervals):
        for c, d in r:
            total += max(0.0, min(b, d) - max(a, c))
    return total


def analyse(events, top=10):
    """Reads one profiler session's events (FunctionEvent list) with one
    WINDOW_RANGE -> dict with window_s, busy_s, device_ops, idle_gaps,
    merge_device_s (device time of the kernels under MERGE_RANGE).

    The benchmark's ranges appear twice: on the host, and on the device as
    annotations spanning the kernels launched inside them.  The window is
    the host range; kernels and copies are the device events that are not
    annotations; the merge-resolve time is the kernels' time inside the
    device annotations of MERGE_RANGE."""
    window = [e for e in events if e.name == WINDOW_RANGE
              and not _is_device(e)]
    if not window:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev, merge_ranges = [], []
    by_name = collections.defaultdict(float)
    for e in events:
        if not _is_device(e):
            continue
        if e.name.startswith('bench::'):
            if e.name == MERGE_RANGE:
                merge_ranges.append((e.time_range.start, e.time_range.end))
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            dev.append((a, b))
            by_name[e.name] += (b - a) * 1e-6
    busy = union_length(dev) * 1e-6
    cpu = sorted((e for e in events if not _is_device(e)
                  and not e.name.startswith('bench::')),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in cpu]
    gaps = collections.defaultdict(float)
    prev = w0
    for a, b in merged(dev) + [[w1, w1]]:
        if a > prev:
            mid = 0.5 * (a + prev)
            name = 'no host op'
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 500, -1), -1):
                if cpu[j].time_range.end >= mid:
                    name = cpu[j].name
                    break
            gaps[name] += (a - prev) * 1e-6
        prev = max(prev, b)

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {'window_s': (w1 - w0) * 1e-6, 'busy_s': busy,
            'device_ops': top_of(by_name), 'idle_gaps': top_of(gaps),
            'merge_device_s': _overlap(dev, merge_ranges) * 1e-6}


def profile_calls(call, n_calls, device):
    """n_calls of call() under torch.profiler inside WINDOW_RANGE (ended by
    a synchronise) -> analyse()'s dict."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = device.type == 'cuda'
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_RANGE):
            for _ in range(n_calls):
                call()
            if cuda:
                torch.cuda.synchronize(device)
    return analyse(prof.events())
