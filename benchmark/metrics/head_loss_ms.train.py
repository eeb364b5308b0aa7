"""`head_loss_ms.train`: mean milliseconds of the `head_loss` span
over the traced run's span phase (train calls), the device
synchronised at each boundary."""


def read(ctx):
    if ctx.get('kind') != 'train':
        return None
    spans = ctx.get('spans', {}).get('head_loss')
    return sum(spans) / len(spans) if spans else None
