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
  - ConvBlock:          the `kernel` of a block with output_padding (SSFA's
                        k3 s2 p1 op1 deconvolutions: JAX correlates the
                        lhs-dilated input with it) -> the block's `weight`,
                        torch's ConvTranspose2d layout, by the same flip
  - DenseConvBN:        (kz*ky*kx, Cin, Cout), tap = dz*ky*kx + dy*kx + dx
                        -> conv3d weight (Cout, Cin, kz, ky, kx)
  - sparse convs:       (K, Cin, Cout) kernels kept as they are (subm,
                        strided and inverse)
  - MaskedBatchNorm, and the plain BatchNorm of the DeepLabV3 depth
    network (`<name>.BatchNorm_0`, flax nn.BatchNorm's leaves):
                        scale / bias / mean / var -> weight / bias /
                        running_mean / running_var

The rules are by module type, so every family's names follow: e.g.
PointPillars' `vfe.PFNLayer_<i>.Dense_0` / `MaskedBatchNorm_0`,
SECOND-multihead's `dense_head.shared_conv` (a ConvBlock) and
`head<i>_conv_cls` / `_conv_box` / `_conv_dir_cls`, SECOND-IoU's
`roi_head.shared_<i>` / `shared_bn<i>` / `iou_<i>` / `iou_bn<i>` /
`iou_pred`, PV-RCNN's `pfe.sa_<source>.mlp_r<i>.{mlp_<j>, bn_<j>}`,
`pfe.fusion` / `fusion_bn`, `point_head_simple.{cls_<i>, cls_bn<i>,
cls_out}` and `roi_head.roi_grid_pool.mlp_r<i>.*`, `shared_<i>`,
`cls_fc_<i>`, `reg_fc_<i>` with their `_bn<i>`, `cls_pred`, `reg_pred`,
PartA2's `backbone_3d.up<l>_{t_c1, t_c2, m, inv}`, `part_head.{cls, part,
reg}_<i>` / `_bn<i>` / `{cls, part, box}_out` and `roi_head.conv_{part,
rpn}_<i>` (DenseConvBN over the pooled (x, y, z) grids), PointRCNN's
`backbone_3d.sa_<i>.mlp_r<j>.{mlp_<k>, bn_<k>}` and
`backbone_3d.fp_<i>.SharedMLP_0.*` (PointNet2MSG), `point_head.{cls,
reg}_<i>` / `_bn<i>` / `cls_out` / `box_out` (PointHeadBox) and
`roi_head.xyz_up.mlp_<i>` (or with USE_BN `xyz_up_<i>` / `xyz_up_bn_<i>`),
`merge_down` (`_bn`), `sa_<l>.mlp_<i>` (`bn_<i>`), `{cls, reg}_<i>` /
`_bn<i>` / `_out` (PointRCNNHead): Linear and MaskedBatchNorm leaves all.
PV-RCNN++'s VectorPool modules (`pfe.vp_<source>`, `roi_head.
roi_grid_vpool`: `group_<k>.{separate_w, separate_bn, post_<i>,
post_bn<i>}`, `msg_<i>`, `msg_bn<i>`) add one rule:

  - VectorPoolAggregation: `separate_w` (G, C_in, D) kept as it is

CaDDN's `vfe.ddn.*` (DDNLite's `ConvBlock_<i>`, `Dense_<i>`, `Conv_<i>`,
`MaskedBatchNorm_<i>`; DDNDeepLabV3's `backbone.conv1`, `backbone.bn1`,
`backbone.layer<l>_<b>.{conv<k>, bn<k>, downsample_conv, downsample_bn}`,
`aspp.{conv<i>, bn<i>, conv_pool, bn_pool, project, project_bn}`,
`head_conv`, `head_bn`, `head_out`), `vfe.channel_reduce` and
`map_to_bev.ConvBlock_0` follow the same rules, as do `layers.MLP`'s
`Dense_<i>` / `MaskedBatchNorm_<i>` and the fractional-stride up-branch
of BaseBEVBackbone (a `ConvBlock_<i>.Conv_0` of kernel and stride 1 / s).

It raises on any leaf it does not consume and on any port parameter or
buffer it does not set.  `port_to_jax_variables` applies the rules the
other way, the port's net as a JAX variables tree.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.ddn_deeplab import BatchNorm
from ..models.layers import ConvBlock, MaskedBatchNorm
from ..models.spconv_backbone import (DenseConvBN, InverseConvBN,
                                      SparseConvBN, SubMConvBN)
from ..models.vector_pool import VectorPoolAggregation

_SPARSE = (SubMConvBN, SparseConvBN, InverseConvBN)
_BATCH_NORMS = (MaskedBatchNorm, BatchNorm)

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
    if isinstance(module, _BATCH_NORMS) and leaf in _BN_NAMES:
        return _BN_NAMES[leaf], value
    if isinstance(module, nn.Linear) and leaf in ('kernel', 'bias'):
        return ('weight', value.T) if leaf == 'kernel' else ('bias', value)
    if isinstance(module, (nn.ConvTranspose2d, ConvBlock)) and \
            leaf == 'kernel':
        return 'weight', value[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d) and leaf in ('kernel', 'bias'):
        return (('weight', value.transpose(3, 2, 0, 1)) if leaf == 'kernel'
                else ('bias', value))
    if isinstance(module, DenseConvBN) and leaf == 'kernel':
        cin, cout = value.shape[1:]
        w = value.reshape(*module.kernel_size, cin, cout)
        return 'weight', w.transpose(4, 3, 0, 1, 2)
    if isinstance(module, _SPARSE) and leaf == 'kernel':
        return 'kernel', value
    if isinstance(module, VectorPoolAggregation) and leaf == 'separate_w':
        return 'separate_w', value
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


_BN_LEAVES = {v: ('params' if k in ('scale', 'bias') else 'batch_stats', k)
              for k, v in _BN_NAMES.items()}


def _export(module, name, value):
    """The inverse of _convert: (collection, JAX leaf name, array in the
    JAX layout) for one port tensor."""
    if isinstance(module, _BATCH_NORMS) and name in _BN_LEAVES:
        return (*_BN_LEAVES[name], value)
    if isinstance(module, nn.Linear):
        return ('params', 'kernel', value.T) if name == 'weight' \
            else ('params', 'bias', value)
    if isinstance(module, (nn.ConvTranspose2d, ConvBlock)) and \
            name == 'weight':
        return 'params', 'kernel', value.transpose(2, 3, 0, 1)[::-1, ::-1]
    if isinstance(module, nn.Conv2d):
        return ('params', 'kernel', value.transpose(2, 3, 1, 0)) \
            if name == 'weight' else ('params', 'bias', value)
    if isinstance(module, DenseConvBN) and name == 'weight':
        cout, cin = value.shape[:2]
        return ('params', 'kernel',
                value.transpose(2, 3, 4, 1, 0).reshape(-1, cin, cout))
    if isinstance(module, _SPARSE) and name == 'kernel':
        return 'params', 'kernel', value
    if isinstance(module, VectorPoolAggregation) and name == 'separate_w':
        return 'params', 'separate_w', value
    raise KeyError(f'no rule for {name!r} of {type(module).__name__}')


def jax_path_and_shape(net: nn.Module, key: str, shape):
    """(JAX path, JAX shape) of the port tensor `key` of `shape`, by the
    rules of _export, without its values."""
    *mods, name = key.split('.')
    coll, leaf, arr = _export(net.get_submodule('.'.join(mods)), name,
                              np.empty(shape, np.int8))
    return (coll, *mods, leaf), arr.shape


def port_tree_to_jax(net: nn.Module, arrays: dict) -> dict:
    """{port parameter key: array in the port's layout} (e.g. an optimizer
    moment per parameter) -> the JAX params tree of numpy arrays, the
    inverse of jax_tree_to_port."""
    out = {}
    for key, arr in arrays.items():
        *mods, name = key.split('.')
        coll, leaf, value = _export(net.get_submodule('.'.join(mods)), name,
                                    np.asarray(arr))
        if coll != 'params':
            raise KeyError(f'{key} is not a parameter')
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(value)
    return out


def port_to_jax_variables(net: nn.Module) -> dict:
    """The port's parameters and BN statistics as a glenet_tpu variables
    tree of numpy arrays ({'params', 'batch_stats'}, JAX layouts), the
    inverse of load_jax_variables: the template a reference checkpoint is
    converted into (utils/weight_converter.convert_full_model)."""
    out = {'params': {}, 'batch_stats': {}}
    for key, t in net.state_dict().items():
        *mods, name = key.split('.')
        coll, leaf, arr = _export(net.get_submodule('.'.join(mods)), name,
                                  t.detach().cpu().numpy())
        node = out[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out


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
