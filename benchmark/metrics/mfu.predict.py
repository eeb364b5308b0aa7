"""`mfu.predict`: model FLOPs of the traced run's plain phase (benchmark/
flops.py: sparse convolutions by their real site pairs, dense ones by
shape, a training step as three forwards) over that phase's wall time, as
a share of the card's dense bf16 peak."""


def read(ctx):
    if ctx.get('kind') != 'predict' or not ctx.get('peaks'):
        return None
    flops, seconds = ctx.get('plain_flops'), ctx.get('plain_s')
    if not flops or not seconds:
        return None
    return 100.0 * flops / seconds / ctx['peaks']['bf16_flops']
