"""Weights made from the seed, on the device, in a few large draws.

The program and the reference get the same tensors: a dict from the
program's parameter and buffer names to float32 tensors (the names are
the port's layout, `backbone_3d.conv2_0.kernel` and so on, which the
references read).  Rules, as `utils/synthetic.seeded_detector` draws its
weights, here without the detour through the host:
  - a convolution kernel or a dense weight: normal with standard deviation
    1 / sqrt(fan in), or the configuration's `weight_std` for its name;
  - a BN layer: scale in [0.5, 1.5), shift normal * 0.1, running mean
    normal * 0.1, running variance in [0.5, 1.5), so BN is no identity;
  - any other bias: the configuration's `bias_init` for its name (the
    heads' score priors), else 0.
"""
from __future__ import annotations

import math

import torch


def fan_in(name, shape):
    """Inputs summed into one output of the layer the weight belongs to."""
    if name.endswith('.kernel'):                  # sparse (taps, Cin, Cout)
        return math.prod(shape[:-1])
    if 'ConvTranspose' in name:                   # (Cin, Cout, k, k), s == k
        return shape[0]
    return math.prod(shape[1:])                   # (Cout, Cin, ...)


def seeded_weights(layout, bn_prefixes, seed, device, assumed):
    """layout: [(name, shape)] of the program's state dict; bn_prefixes:
    the BN layers' name prefixes -> {name: tensor} drawn from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    std_of = assumed.get('weight_std', {})
    bias_of = assumed.get('bias_init', {})

    def is_bn(name):
        return name.rsplit('.', 1)[0] in bn_prefixes

    dense = [(n, s) for n, s in layout if len(s) >= 2 and not is_bn(n)]
    bn = [(n, s) for n, s in layout if is_bn(n)]
    normal = torch.randn(sum(math.prod(s) for _, s in dense) + sum(
        math.prod(s) for _, s in bn), generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(s) for _, s in bn), generator=gen,
                         device=device)
    out, i, j = {}, 0, 0
    for name, shape in dense:
        n = math.prod(shape)
        std = std_of.get(name, 1.0 / math.sqrt(fan_in(name, shape)))
        out[name] = normal[i:i + n].reshape(shape) * std
        i += n
    for name, shape in bn:
        n = math.prod(shape)
        kind = name.rsplit('.', 1)[1]
        if kind in ('weight', 'running_var'):
            out[name] = uniform[j:j + n].reshape(shape) + 0.5
            j += n
        else:
            out[name] = normal[i:i + n].reshape(shape) * 0.1
            i += n
    for name, shape in layout:
        if name not in out:
            out[name] = torch.full(shape, float(bias_of.get(name, 0.0)),
                                   device=device)
    return out
