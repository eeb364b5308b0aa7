"""The program's counters in a traced run, as the per-layer readers take
them: `glenet_tpu_torch/utils/trace.py` counts only while a profiler
records, so its totals are those of the traced run's profiler phase, and
`calls` the calls made there.  None where the program has no counters or
counted no call."""
from __future__ import annotations


def program_trace():
    """The program's tracing module, or None where it has none."""
    try:
        from glenet_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def trace_counters():
    """{counter: total} of the program, with `calls`; or None."""
    trace = program_trace()
    counts = trace.counters() if trace else {}
    return counts if counts.get('calls') else None


def per_call(counts, name):
    """Counter `name` per call."""
    return counts.get(name, 0) / counts['calls']


def dropped_pct(counts, offered, kept):
    """100 (1 - kept / offered), over every counter whose name is `offered`
    or starts with `offered.` (and the same of `kept`); None where nothing
    was offered."""
    def total(name):
        return sum(v for k, v in counts.items()
                   if k == name or k.startswith(name + '.'))

    n = total(offered)
    return 100.0 * (1.0 - total(kept) / n) if n else None
