"""`device_idle_pct.train`: share of the profiler window in which no
kernel or copy ran on the device: 100 * (1 - union of the device
intervals / the window's wall time)."""


def read(ctx):
    prof = ctx.get('profile') if ctx.get('kind') == 'train' else None
    if not prof or prof['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - prof['busy_s'] / prof['window_s'])
