"""`dense_head_ms.predict`: mean milliseconds of the `dense_head` span
over the traced run's span phase (predict calls), the device
synchronised at each boundary."""


def read(ctx):
    if ctx.get('kind') != 'predict':
        return None
    spans = ctx.get('spans', {}).get('dense_head')
    return sum(spans) / len(spans) if spans else None
