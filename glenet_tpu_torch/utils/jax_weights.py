"""Weight bridge: glenet_tpu variables -> the port's parameters and buffers.

Takes the JAX package's nested `{'params': ..., 'batch_stats': ...}` dict
as numpy arrays (e.g. `jax.tree.map(np.asarray, variables)`), so it imports
no JAX.  It maps the detector (`DetectorNet`) and the CVAE
(`cvae.model.CVAEGenerator`).  The port's modules are named after the JAX
variable paths, so each leaf `collection/mod/.../name` lands in the torch
module at `mod.(...)`, converted by that module's type:

  - nn.Linear:          Dense kernel (in, out) -> weight (out, in)
  - nn.Conv2d:          HWIO kernel -> OIHW weight
  - nn.ConvTranspose2d: (kH, kW, I, O) kernel -> (I, O, kH, kW), spatially
                        flipped (flax's transpose conv correlates the
                        dilated input with the kernel unflipped)
  - DenseConvBN:        (kz*ky*kx, Cin, Cout), tap = dz*ky*kx + dy*kx + dx
                        -> conv3d weight (Cout, Cin, kz, ky, kx)
  - sparse convs:       (27, Cin, Cout) kernels kept as they are
  - MaskedBatchNorm:    scale / bias / mean / var -> weight / bias /
                        running_mean / running_var

It raises on any leaf it does not consume and on any port parameter or
buffer it does not set.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.layers import MaskedBatchNorm
from ..models.spconv_backbone import DenseConvBN, SparseConvBN, SubMConvBN

_BN_NAMES = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
             'var': 'running_var'}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(module, leaf, value):
    """(port attribute name, torch-layout array) for one JAX leaf."""
    if isinstance(module, MaskedBatchNorm) and leaf in _BN_NAMES:
        return _BN_NAMES[leaf], value
    if isinstance(module, nn.Linear) and leaf in ('kernel', 'bias'):
        return ('weight', value.T) if leaf == 'kernel' else ('bias', value)
    if isinstance(module, nn.ConvTranspose2d) and leaf == 'kernel':
        return 'weight', value[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d) and leaf in ('kernel', 'bias'):
        return (('weight', value.transpose(3, 2, 0, 1)) if leaf == 'kernel'
                else ('bias', value))
    if isinstance(module, DenseConvBN) and leaf == 'kernel':
        cin, cout = value.shape[1:]
        w = value.reshape(*module.kernel_size, cin, cout)
        return 'weight', w.transpose(4, 3, 0, 1, 2)
    if isinstance(module, (SubMConvBN, SparseConvBN)) and leaf == 'kernel':
        return 'kernel', value
    raise KeyError(f'no rule for leaf {leaf!r} of {type(module).__name__}')


def convert_leaf(net: nn.Module, collection: str, path, value):
    """One JAX leaf at `path` (a tuple of names) of `collection` -> (port
    state key, array in the port's layout).  The layout rules are
    permutations and reshapes, so they map a gradient tree as they map the
    variables."""
    *mods, leaf = path
    try:
        module = net.get_submodule('.'.join(mods))
    except AttributeError as e:
        raise KeyError(f'JAX leaf {collection}/{"/".join(path)} has no port '
                       f'module') from e
    name, arr = _convert(module, leaf, np.asarray(value))
    return '.'.join([*mods, name]), arr.copy(order='C')


def jax_tree_to_port(net: nn.Module, tree: dict, collection: str = 'params'):
    """A JAX tree of one collection (e.g. a gradient tree, params only) ->
    {port key: numpy array in the port's layout}."""
    return dict(convert_leaf(net, collection, path, value)
                for path, value in _leaves(tree))


def load_jax_variables(net: nn.Module, variables: dict) -> None:
    """Copy JAX variables into `net` (a DetectorNet, a CVAEGenerator or any
    port module whose attribute paths follow the JAX variable paths)."""
    targets = dict(net.named_parameters())
    targets.update(net.named_buffers())
    persistent = set(net.state_dict())
    unset = {k for k in targets if k in persistent}
    for collection in variables:
        if collection not in ('params', 'batch_stats'):
            raise KeyError(f'unknown JAX collection {collection!r}')
    for collection in ('params', 'batch_stats'):
        for key, arr in jax_tree_to_port(
                net, variables.get(collection, {}), collection).items():
            t = targets[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f'{key}: JAX shape {arr.shape} vs port '
                                 f'{tuple(t.shape)}')
            with torch.no_grad():
                t.copy_(torch.from_numpy(arr).to(t.dtype))
            unset.discard(key)
    if unset:
        raise KeyError(f'port parameters not set by the JAX variables: '
                       f'{sorted(unset)}')
