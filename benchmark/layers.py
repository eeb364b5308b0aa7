"""Each layer's device time and idle time in a profiler window, from the
program's spans.

The port opens a profiler range at each layer boundary
(`glenet_tpu_torch/utils/trace.py`): `glenet::<layer>` host ranges of the
profiler's function scope, nested under one top range a call
(`glenet::predict`, `glenet::train_step`), on the clock of the device's
kernels and copies.  `layers(events)`:
  - assigns every kernel and copy to the innermost span open on the host
    when its launch (the runtime call with the same correlation id) began.
    By time, not by thread: autograd launches the backward's kernels from
    its own thread while the caller waits inside `glenet::backward`;
  - splits every stretch in which the device runs nothing at the spans'
    host boundaries, and gives each piece to the innermost span open then;
  - gives what falls outside every span to `outside`.
A span's busy time is the union of its kernels' intervals; busy plus idle
over every name, `outside` included, is the window.  Annotations on the
device's timeline (user-scope ranges) are not work and are left out.

Run as a script, it drives a cell's call as the traced run's profiler
phase does and prints the layers, the program's counters, the host waits
that `torch.cuda.set_sync_debug_mode` reports, and what tracing costs:

    python3 benchmark/layers.py --workload NAME --seed N [--calls K]
"""
from __future__ import annotations

import bisect
import collections

PREFIX = 'glenet::'
TOP = ('predict', 'train_step')
OUTSIDE = 'outside'
WINDOW_RANGE = 'bench::window'


def _is_device(ev):
    import torch
    return ev.device_type != torch.autograd.DeviceType.CPU


def _is_annotation(ev):
    return (getattr(ev, 'is_user_annotation', False)
            or ev.name.startswith(('bench::', PREFIX)))


def _is_launch(ev):
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...): its id is the correlation id of the device work
    it started."""
    return ev.name.startswith('cu')


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class _Innermost:
    """The innermost span open at a time: the host's span boundaries cut
    the timeline into pieces, each with the span of latest start among
    those covering it (spans nest, so that is the innermost)."""

    def __init__(self, spans):
        edges = sorted({t for s in spans for t in s[1:]})
        self.edges = edges
        self.names = []
        for a, b in zip(edges, edges[1:]):
            mid = 0.5 * (a + b)
            best = None
            for name, s0, s1 in spans:
                if s0 <= mid < s1 and (best is None or s0 >= best[1]):
                    best = (name, s0)
            self.names.append(best[0] if best else OUTSIDE)

    def at(self, t):
        i = bisect.bisect_right(self.edges, t) - 1
        if i < 0 or i >= len(self.names):
            return OUTSIDE
        return self.names[i]

    def pieces(self, a, b):
        """(name, length) of the pieces of [a, b)."""
        i = bisect.bisect_right(self.edges, a)
        j = bisect.bisect_left(self.edges, b)
        cuts = [a] + self.edges[i:j] + [b]
        return [(self.at(0.5 * (x + y)), y - x)
                for x, y in zip(cuts, cuts[1:]) if y > x]


def layers(events, top=8):
    """One profiler session's events (FunctionEvent list; the window is the
    host range WINDOW_RANGE, else the first top span's start to the last
    one's end) -> dict, or None without program spans:
      calls: top spans that began in the window;
      window_ms: the window per call;
      busy_ms, idle_ms: {span name (prefix dropped) or 'outside': ms per
        call};
      ops: {name: [[host op that launched the work, device ms per call],
        ...]}, the `top` largest;
      unmatched: device operations whose launch was not found (placed by
        their own start)."""
    host = [e for e in events if not _is_device(e)]
    spans = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
             for e in host if e.name.startswith(PREFIX)]
    if not spans:
        return None
    tops = sorted((s for s in spans if s[0] in TOP), key=lambda s: s[1])
    window = [e for e in host if e.name == WINDOW_RANGE]
    if window:
        w0, w1 = window[0].time_range.start, window[0].time_range.end
    elif tops:
        w0, w1 = tops[0][1], tops[-1][2]
    else:
        return None
    calls = sum(w0 <= s[1] < w1 for s in tops)
    if not calls:
        return None
    where = _Innermost(spans)
    launches = {e.id: e for e in host if _is_launch(e)}
    work = collections.defaultdict(list)
    ops = collections.defaultdict(collections.Counter)
    every, unmatched = [], 0
    for e in events:
        if not _is_device(e) or _is_annotation(e):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        launch = launches.get(e.id)
        if launch is None:
            unmatched += 1
            t, op = e.time_range.start, 'no launch found'
        else:
            t = launch.time_range.start
            parent = getattr(launch, 'cpu_parent', None)
            op = parent.name if parent is not None else 'no host op'
        name = where.at(t)
        work[name].append((a, b))
        ops[name][op] += b - a
        every.append((a, b))
    idle = collections.defaultdict(float)
    prev = w0
    for a, b in sorted(every) + [(w1, w1)]:
        if a > prev:
            for name, length in where.pieces(prev, a):
                idle[name] += length
        prev = max(prev, b)
    per = 1e-3 / calls          # microseconds of the window -> ms per call
    names = sorted(set(work) | set(idle))
    return {
        'calls': calls, 'window_ms': (w1 - w0) * per,
        'busy_ms': {n: _union(work[n]) * per for n in names},
        'idle_ms': {n: idle[n] * per for n in names},
        'ops': {n: [[op, us * per] for op, us in ops[n].most_common(top)]
                for n in names if ops[n]},
        'unmatched': unmatched}


def _sync_sites(call, n):
    """n calls with torch.cuda's sync debug mode warning -> {site: waits
    per call}: the innermost frame of the program (`port file:line`), else
    of the benchmark."""
    import traceback
    import warnings

    import torch
    sites = collections.Counter()
    real = warnings.showwarning
    inside = [False]        # only the calls' own waits, not the switch's

    def show(message, category, filename, lineno, file=None, line=None):
        if 'synchroniz' not in str(message):
            return real(message, category, filename, lineno, file, line)
        if not inside[0]:
            return None
        stack = traceback.extract_stack()[:-1]
        for tag, key in (('port', '/glenet_tpu_torch/'),
                         ('benchmark', '/benchmark/')):
            frames = [f for f in stack if key in f.filename]
            if frames:
                f = frames[-1]
                sites[f'{tag} {f.filename.split(key)[1]}:{f.lineno}'] += 1
                return None
        sites['elsewhere'] += 1
        return None

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode('warn')
        inside[0] = True
        try:
            for _ in range(n):
                call()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(0)
    return {k: v / n for k, v in sites.most_common()}


def _rate(call, n, sync):
    import time
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    sync()
    return n / (time.perf_counter() - t0)


def _off_path_ns(n=200000):
    """Host ns of one `with span(...)` and of one `count(...)` with tracing
    off, beside an empty call; None where the program has no spans."""
    import time

    from benchmark.counters import program_trace
    trace = program_trace()
    if trace is None:
        return None

    def one_span():
        with trace.span('x'):
            pass

    def per(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e9

    return {'span': per(one_span), 'count': per(lambda: trace.count('x')),
            'empty_call': per(lambda: None)}


def measure(session, n, device):
    """The script's readings over `session`'s call (a driver's Session,
    warmed up): calls per second with tracing off, then in a profiler
    window of n calls (analyse(), layers(), the program's counters), the
    host waits by site (on a card), the rate off again, the off path's
    cost."""
    import time

    import torch

    from benchmark import tracing
    from benchmark.counters import program_trace
    trace = program_trace()
    cuda = device.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    out = {'calls': n, 'rate_off': _rate(session.call, n, sync)}
    if trace:
        trace.reset()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tracing.WINDOW_RANGE):
            t0 = time.perf_counter()
            for _ in range(n):
                session.call()
            sync()
            out['rate_profiled'] = n / (time.perf_counter() - t0)
    events = prof.events()
    out['analyse'] = tracing.analyse(events)
    out['layers'] = layers(events)
    out['counters'] = trace.counters() if trace else None
    if cuda:
        out['sync_sites'] = _sync_sites(session.call, max(2, n // 3))
    out['rate_off_after'] = _rate(session.call, n, sync)
    out['off_path_ns'] = _off_path_ns()
    return out


def main(argv=None):
    import argparse
    import json
    import sys
    import time
    import types
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--calls', type=int, default=12)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness
    bench, cell, conf, config, traffic, limits = harness.find_cell(
        root, args.workload)
    dev = torch.device('cuda', 0)
    h = types.SimpleNamespace(seed=args.seed, seconds=0, trace=True,
                              t0=time.perf_counter(), config=config,
                              conf=conf, traffic=traffic, limits=limits,
                              device=dev)
    s = harness.driver(traffic['kind']).Session(h, args.seed)
    for _ in range(3):
        s.call()
    out = {'workload': args.workload, 'seed': args.seed,
           'card': torch.cuda.get_device_name(dev)}
    out.update(measure(s, args.calls, dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
