"""`voxelize_vfe_ms.predict`: mean milliseconds of the `voxelize_vfe` span
over the traced run's span phase (predict calls), the device
synchronised at each boundary."""


def read(ctx):
    if ctx.get('kind') != 'predict':
        return None
    spans = ctx.get('spans', {}).get('voxelize_vfe')
    return sum(spans) / len(spans) if spans else None
