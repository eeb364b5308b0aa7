"""`merge_resolve_roofline.predict`: the merge-resolve calls' least time,
their contract's bytes (each ids / queries byte read once, each output
byte written once) over the card's memory rate, as a share of the device
time of every kernel run inside the ranges the benchmark puts around
`resolve_sorted_queries`, in the profiler window of predict calls."""


def read(ctx):
    prof = ctx.get('profile') if ctx.get('kind') == 'predict' else None
    peaks = ctx.get('peaks')
    if not prof or not peaks or not ctx.get('merge_bytes'):
        return None
    if prof['merge_device_s'] <= 0:
        return None
    least = ctx['merge_bytes'] / peaks['hbm_bytes']
    return 100.0 * least / prof['merge_device_s']
