"""Timing of one GPU function four ways (needs a CUDA device).

- `event_ms`: CUDA events around back-to-back calls.  When the host issues
  calls more slowly than the card runs them, this measures the host.
- `host_ms`: host clock around calls with no synchronise: what one call
  costs the host to issue.
- `device_ms`: the kernels' own device time, from torch.profiler's CUDA
  kernel events whose name contains a given string.
- `cold_ms`: CUDA events around one call after a write of a scratch buffer
  larger than the 50 MB L2, so the call finds its inputs in device memory.
  The write takes longer than the host needs to issue the call, so the
  events bracket the kernel alone.
All return milliseconds per call.  `profile_window` runs a window of
calls under torch.profiler and gives its wall time and summed device time,
whose ratio is the device's busy share.  `card_line` gives the card's name
and power limit, to print beside them.
"""
from __future__ import annotations

import subprocess
import time

import torch

FLUSH_BYTES = 256 << 20


def card_line():
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def event_ms(fn, iters=100, warmup=10):
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def host_ms(fn, iters=500, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def device_ms(fn, match, iters=20, warmup=3):
    """Summed device time of the CUDA kernels whose name contains `match`,
    per call; None if the profiler saw no such kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = [e.self_device_time_total for e in prof.key_averages()
          if e.device_type == cuda and match in e.key]
    return sum(us) / 1e3 / iters if us else None


def profile_window(fn, n):
    """n calls of fn() under torch.profiler, with no synchronise between
    them -> (wall ms of the window, summed device ms of its CUDA kernels,
    the profiler's key_averages())."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev = sum(e.self_device_time_total for e in events
              if e.device_type == cuda) / 1e3
    return wall, dev, events


def cold_ms(fn, iters=10, warmup=2):
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device='cuda')
    for _ in range(warmup):
        fn()
    pairs = []
    for i in range(iters):
        flush.fill_(i)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters
