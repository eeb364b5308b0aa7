"""Drivers: one per traffic `kind`, each `run(h) -> dict` (see run.py).

The measured loop is closed with one caller: the next call starts when the
last one's result is on the host.  A traced run splits its window in
three phases: plain calls (the whole call's time, for `mfu.*`), a
profiler session over a few calls (device busy share, breakdown, the
merge-resolve ranges), and calls with synchronised spans.
"""
from __future__ import annotations

import time

from .. import tracing


def closed_loop(call, seconds):
    """call() until `seconds` have passed -> (latencies in s, window start,
    window end): the window ends when the last call returns."""
    lat = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        call()
        b = time.perf_counter()
        lat.append(b - a)
        if b - t0 >= seconds:
            return lat, t0, b


def traced(call, seconds, profiled_calls, attach, pairs, merge_module,
           device):
    """The three phases of a traced run -> dict: plain_calls, plain_s,
    profile (tracing.analyse), merge_bytes, spans ({span: [ms]})."""
    lat, t0, t1 = closed_loop(call, seconds / 3)
    log = []
    with tracing.merge_ranges(merge_module, log):
        profile = tracing.profile_calls(call, profiled_calls, device)
    spans = tracing.Spans(device)
    attach(spans)

    def span_call():
        spans.start_call()
        call()
        spans.mark('end')

    try:
        closed_loop(span_call, seconds / 3)
    finally:
        spans.remove()
    return {'plain_calls': len(lat), 'plain_s': t1 - t0,
            'profile': profile, 'merge_bytes': sum(log),
            'spans': spans.durations(pairs)}
