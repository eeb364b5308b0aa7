"""`sites_dropped_pct.train`: the share of active output sites of the
strided sparse convolutions that rank decimation left out past the level
caps, over every level (the program's counters `sites_active.<grid>`
and `sites_kept.<grid>`), over the traced run's profiler phase.  It
guards `correct`: a cap that drops sites changes the answer."""
from benchmark import counters


def read(ctx):
    counts = counters.trace_counters()
    if ctx.get('kind') != 'train' or counts is None:
        return None
    return counters.dropped_pct(counts, 'sites_active', 'sites_kept')
