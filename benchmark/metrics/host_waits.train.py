"""`host_waits.train`: the program's counter `host_waits` per train call
(one step) of the traced run's profiler phase: the times the host waits
for the device's stream at a device-to-host read or a pageable
host-to-device copy on the program's path."""
from benchmark import counters


def read(ctx):
    counts = counters.trace_counters()
    if ctx.get('kind') != 'train' or counts is None:
        return None
    return counters.per_call(counts, 'host_waits')
