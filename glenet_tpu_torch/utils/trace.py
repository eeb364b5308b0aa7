"""The port's spans and counters: where a call spends its time, and what it
counts on the way (host waits, budget drops, kernel launches).

Tracing is on while a `torch.profiler` session is recording, and only
then: whoever runs a profiler over the port gets its layers, with no switch
of the port's own.  Off, `span` returns one shared object that does
nothing and `count` returns at once; each costs a flag test.

On, a span is a profiler range named `glenet::<name>`, recorded on the
profiler's clock beside every kernel and copy it launches, and kept by the
profiler until its session ends; the port writes nothing of its own.  Each
call of the port opens one top span (`call_span`: `glenet::predict`,
`glenet::train_step`) that carries the call's index as its argument, and
the layers' spans nest inside it.  The ranges are of the profiler's
function scope, as an operator is: a user-scope range (`record_function`)
also appears on the device's timeline, as an annotation spanning its
kernels, which a reader of device time would take for work.

Counters sum host integers, or device tensors on the device: a count
launches at most one reduction and reads nothing back, and a kernel can
add to `device_slots` itself.  `counters()` reads them all with one
synchronise once the work is done.  A site is counted on any device:
`host_waits` counts the places where the host waits for the card when
the tensors are on it.
"""
from __future__ import annotations

import collections

import torch

PREFIX = 'glenet::'

_enabled = torch.autograd._profiler_enabled


class _Off:
    """The span of a call made with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()

_host = collections.Counter()       # name -> int
_pending = {}                       # name -> [0-dim integer tensors]
_slots = {}                 # (names, device) -> int32 tensor, one per name
_calls = 0


def _range(name, *args):
    """A function-scope profiler range; `args`: at most its list of
    argument values."""
    return torch._C._profiler._RecordFunctionFast(PREFIX + name, *args)


def enabled() -> bool:
    """Whether tracing is on: a profiler session is recording."""
    return _enabled()


def span(name: str):
    """Context manager around one layer of a call."""
    if not _enabled():
        return OFF
    return _range(name)


def call_span(name: str):
    """Context manager around one whole call (`predict`, `train_step`):
    the top span, with the call's index among the traced calls as its
    argument."""
    global _calls
    if not _enabled():
        return OFF
    _calls += 1
    return _range(name, [_calls - 1])


def count(name: str, n=1):
    """Add `n` to the counter `name`: an int, or an integer or bool tensor,
    summed on its device."""
    if not _enabled():
        return
    if not isinstance(n, torch.Tensor):
        _host[name] += int(n)
        return
    n = n.detach()
    if n.dim():
        n = n.sum(dtype=torch.int64)
    _pending.setdefault(name, []).append(n)


def device_slots(names, device):
    """A zeroed int32 tensor on `device`, one element per counter of
    `names` (a tuple), that a kernel adds its counts to; the same tensor
    until the next reset.  None with tracing off."""
    if not _enabled():
        return None
    key = (names, torch.device(device))
    t = _slots.get(key)
    if t is None:
        t = _slots[key] = torch.zeros(len(names), dtype=torch.int32,
                                      device=device)
    return t


def _total(part):
    return torch.stack([t.to(torch.int64) for t in part]).sum()


def counters() -> dict:
    """{counter: total} since the last reset, plus `calls`: the top spans
    opened with tracing on.  Synchronises once to read the device counts."""
    out = dict(_host)
    names, vals = [], []
    for name, part in _pending.items():
        names.append(name)
        vals.append(_total(part))
    for (group, _), t in _slots.items():
        names.extend(group)
        vals.extend(t.to(torch.int64).unbind())
    if vals:
        dev = vals[0].device
        for name, v in zip(names, torch.stack([v.to(dev) for v in vals])
                           .tolist()):
            out[name] = out.get(name, 0) + v
    out['calls'] = _calls
    return out


def reset():
    """Zero every counter and the call index."""
    global _calls
    _host.clear()
    _pending.clear()
    _slots.clear()
    _calls = 0
