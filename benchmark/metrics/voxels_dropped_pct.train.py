"""`voxels_dropped_pct.train`: the share of occupied voxels that voxelize
left out past the voxel budget (the program's counters `voxels_offered`
and `voxels_kept`) over the traced run's profiler phase.  It guards
`correct`: a budget that drops voxels changes the answer."""
from benchmark import counters


def read(ctx):
    counts = counters.trace_counters()
    if ctx.get('kind') != 'train' or counts is None:
        return None
    return counters.dropped_pct(counts, 'voxels_offered', 'voxels_kept')
