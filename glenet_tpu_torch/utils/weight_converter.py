"""Reference (pcdet) checkpoints -> glenet_tpu's variable layout, for the
families the port runs: MeanVFE (or DynMeanVFE) + VoxelBackBone8x,
VoxelBackBone8xCiassd or VoxelResBackBone8x + HeightCompression, or
PillarVFE + PointPillarScatter (PointPillars), + BaseBEVBackbone or SSFA +
AnchorHeadSingle, the KL-label heads or CenterHead (CenterPoint, and the
RPN of VoxelRCNN, PVRCNN and PVRCNNPlusPlus), and for
VoxelRCNN (GLENet-VR, plain Voxel R-CNN) the roi head; SECONDNet
(GLENet-S, GLENet-C, plain SECOND) and PointPillar have none, and
SECOND-IoU's SECONDHead and the stage 2 of PV-RCNN and PV-RCNN++
(VoxelSetAbstraction, PointHeadSimple, PVRCNNHead) are not converted
(their keys are reported unconsumed, as glenet_tpu's converter leaves
them).  AnchorHeadMulti,
DynPillarVFE (its layers are twice as wide as the reference's from the
second on), PartA2's UNetV2 and PointRCNN's PointNet2MSG have no
conversion, in glenet_tpu either: each raises by name before a key is
read.  The port's
own copy of the matching part of glenet_tpu/utils/weight_converter.py,
numpy only.  It returns the same
flax-shaped {'params', 'batch_stats'} numpy tree, which
utils/jax_weights.load_jax_variables loads into the port.

Layout rules:

  torch Conv2d          (O, I, kH, kW)    -> flax Conv      (kH, kW, I, O)
  torch ConvTranspose2d (I, O, kH, kW)    -> flax ConvTranspose
                                              (kH, kW, O, I) with spatial
                                              flip (flax computes the
                                              gradient-style transpose)
  torch Linear          (O, I)            -> flax Dense     (I, O)
  torch BatchNorm       weight/bias/running_mean/running_var
                        -> params {scale, bias} + batch_stats {mean, var}
  spconv SubMConv3d / SparseConv3d:
      spconv 2.x weight (O, kz, ky, kx, I) -> (K = kz*ky*kx row-major, I, O)
      spconv 1.x weight (kz, ky, kx, I, O) -> (K, I, O)

`convert_ddn_deeplabv3` maps a torchvision deeplabv3_resnet50 / 101 state
dict (CaDDN's reference depth network) to the port's DDNDeepLabV3 by name
alone: both are torch layouts.  The full-model converter refuses CaDDN's
ImageVFE by name, as glenet_tpu's does.

The roi head converts exactly only with ROI_GRID_POOL.POOL_MODE
voxel_query (configs/kitti_models/GLENet_VR_vq.yaml): the default corner
pooling is a redesign whose parameters have no reference counterpart, so
in that mode the roi head keeps the template's values and its reference
keys are listed in the report's `unconsumed`.
"""
from __future__ import annotations

import copy

import numpy as np


# ---------------------------------------------------------------------------
# leaf transforms
# ---------------------------------------------------------------------------

def t2f_conv(w):
    """torch Conv2d (O, I, kH, kW) -> flax (kH, kW, I, O)."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def t2f_conv_transpose(w):
    """torch ConvTranspose2d (I, O, kH, kW) -> flax ConvTranspose
    (kH, kW, I, O): flax correlates with the kernel on the *output* side,
    which equals torch's transposed conv with spatially flipped taps."""
    w = np.asarray(w)
    return np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))


def t2f_linear(w):
    """torch Linear (O, I) -> flax Dense (I, O)."""
    return np.transpose(np.asarray(w), (1, 0))


def t2f_bn(sd, prefix):
    """BatchNorm params + running stats."""
    return ({'scale': np.asarray(sd[f'{prefix}.weight']),
             'bias': np.asarray(sd[f'{prefix}.bias'])},
            {'mean': np.asarray(sd[f'{prefix}.running_mean']),
             'var': np.asarray(sd[f'{prefix}.running_var'])})


def t2f_spconv(w):
    """spconv 3D conv weight -> (K, I, O), K row-major (dz, dy, dx).

    Accepts spconv 2.x (O, kz, ky, kx, I) or 1.x (kz, ky, kx, I, O); the
    two are told apart the way the reference does it: by which end of the
    shape carries the spatial dims."""
    w = np.asarray(w)
    if w.ndim != 5:
        raise ValueError(f'spconv weight of shape {w.shape}: expected 5 dims')
    # spconv1: spatial first (kz, ky, kx, I, O); spconv2: (O, kz, ky, kx, I)
    if w.shape[0] <= 3 and w.shape[1] <= 3 and w.shape[2] <= 3:
        kz, ky, kx, ci, co = w.shape
        return w.reshape(kz * ky * kx, ci, co)
    co, kz, ky, kx, ci = w.shape
    w = np.transpose(w, (1, 2, 3, 4, 0))       # (kz, ky, kx, I, O)
    return w.reshape(kz * ky * kx, ci, co)


# ---------------------------------------------------------------------------
# component converters (params naming mirrors the variable tree)
# ---------------------------------------------------------------------------

def _conv_block(sd, conv_key, bn_key, transpose=False):
    """-> ConvBlock variables: params {Conv_0 (or ConvTranspose_0):
    {kernel}, MaskedBatchNorm_0}, batch_stats {MaskedBatchNorm_0}."""
    w = sd[conv_key]
    kernel = t2f_conv_transpose(w) if transpose else t2f_conv(w)
    bn_p, bn_s = t2f_bn(sd, bn_key)
    conv_name = 'ConvTranspose_0' if transpose else 'Conv_0'
    return ({conv_name: {'kernel': kernel}, 'MaskedBatchNorm_0': bn_p},
            {'MaskedBatchNorm_0': bn_s})


def height_compression_perm(sd, bev_in_key, prefix='backbone_3d.'):
    """Input-channel permutation for the first BEV conv after
    HeightCompression, or None when no sparse conv_out precedes it.

    The reference folds z into channels C-outer (`dense()` gives
    (N, C, D, H, W), then `view(N, C*D, H, W)`, channel index c*D + d),
    while the backbone here folds z-outer (channel index d*C + c).
    Reference BEV weights therefore have their input channels remapped:
    channel (d, c) here reads reference channel c*D + d.
    """
    w_out = sd.get(f'{prefix}conv_out.0.weight')
    if w_out is None or bev_in_key not in sd:
        return None
    w_out = np.asarray(w_out)
    # conv_out channels: spconv2 (O, kz, ky, kx, I) or spconv1 (...,I,O)
    c = w_out.shape[0] if w_out.shape[1] <= 3 else w_out.shape[-1]
    total = np.asarray(sd[bev_in_key]).shape[1]
    d = total // c
    if d * c != total or d == 1:
        return None
    idx = np.arange(total)
    return (idx % c) * d + (idx // c)


def convert_base_bev_backbone(sd, layer_nums, upsample=True, prefix='',
                              in_perm=None):
    """Reference BaseBEVBackbone state_dict -> the BEV backbone subtree.

    Reference naming: blocks.{i} is a Sequential [ZeroPad, Conv, BN, ReLU,
    (Conv, BN, ReLU) x layer_nums[i]], deblocks.{i} is [ConvTranspose, BN,
    ReLU].  Here: a flat sequence of ConvBlock_{k} in call order
    (downsample, n convs, up) per level.  `in_perm` remaps the first conv's
    input channels (height_compression_perm).
    """
    params, stats = {}, {}
    k = 0
    for i, n in enumerate(layer_nums):
        # downsample conv: seq idx 1 (after ZeroPad2d), BN at 2
        p, s = _conv_block(sd, f'{prefix}blocks.{i}.1.weight',
                           f'{prefix}blocks.{i}.2')
        if i == 0 and in_perm is not None:
            p['Conv_0']['kernel'] = p['Conv_0']['kernel'][:, :, in_perm, :]
        params[f'ConvBlock_{k}'] = p
        stats[f'ConvBlock_{k}'] = s
        k += 1
        for j in range(n):
            base = 4 + 3 * j
            p, s = _conv_block(sd, f'{prefix}blocks.{i}.{base}.weight',
                               f'{prefix}blocks.{i}.{base + 1}')
            params[f'ConvBlock_{k}'] = p
            stats[f'ConvBlock_{k}'] = s
            k += 1
        if upsample:
            # KITTI configs use stride >= 1 deconvs
            p, s = _conv_block(sd, f'{prefix}deblocks.{i}.0.weight',
                               f'{prefix}deblocks.{i}.1', transpose=True)
            params[f'ConvBlock_{k}'] = p
            stats[f'ConvBlock_{k}'] = s
            k += 1
    return params, stats


def convert_ssfa(sd, prefix='backbone_2d.', in_perm=None):
    """Reference SSFA state dict -> the SSFA subtree (bev_backbone.SSFA's
    children).  bottom_up_block_0 leads with a ZeroPad2d, so its convs sit
    at Sequential indices 1, 4, 7; every other block is [Conv or
    ConvTranspose, BN, (ReLU)] from index 0.  The k3 s2 p1 op1
    deconvolutions keep their kernel on the ConvBlock itself.  `in_perm`
    remaps the first conv's input channels (height_compression_perm)."""
    params, stats = {}, {}

    def put(ours, conv_key, bn_key, transpose=False):
        p, s = _conv_block(sd, prefix + conv_key, prefix + bn_key,
                           transpose=transpose)
        if transpose:
            p = {'kernel': p['ConvTranspose_0']['kernel'],
                 'MaskedBatchNorm_0': p['MaskedBatchNorm_0']}
        params[ours], stats[ours] = p, s

    for i in range(3):
        put(f'bottom_up_0_{i}', f'bottom_up_block_0.{1 + 3 * i}.weight',
            f'bottom_up_block_0.{2 + 3 * i}')
        put(f'bottom_up_1_{i}', f'bottom_up_block_1.{3 * i}.weight',
            f'bottom_up_block_1.{3 * i + 1}')
    for name in ('trans_0', 'trans_1', 'conv_0', 'conv_1', 'w_0', 'w_1'):
        put(name, f'{name}.0.weight', f'{name}.1')
    for i in (0, 1):
        put(f'deconv_{i}', f'deconv_block_{i}.0.weight',
            f'deconv_block_{i}.1', transpose=True)
    if in_perm is not None:
        k = params['bottom_up_0_0']['Conv_0']['kernel']
        params['bottom_up_0_0']['Conv_0']['kernel'] = k[:, :, in_perm, :]
    return params, stats


def convert_center_head(sd, prefix='dense_head.'):
    """Reference CenterHead (shared_conv, then heads_list.0's SeparateHead
    branches of num_conv 2: [Conv, BN, ReLU] and a biased Conv, one head
    group) -> Conv_0 / MaskedBatchNorm_0 and <name>_0 / <name>_bn0 /
    <name>_1; a conv bias before a BN where the state dict has one."""
    def conv(key):
        d = {'kernel': t2f_conv(sd[f'{key}.weight'])}
        if f'{key}.bias' in sd:
            d['bias'] = np.asarray(sd[f'{key}.bias'])
        return d

    params = {'Conv_0': conv(f'{prefix}shared_conv.0')}
    stats = {}
    params['MaskedBatchNorm_0'], stats['MaskedBatchNorm_0'] = t2f_bn(
        sd, f'{prefix}shared_conv.1')
    for name in ('hm', 'center', 'center_z', 'dim', 'rot'):
        base = f'{prefix}heads_list.0.{name}'
        params[f'{name}_0'] = conv(f'{base}.0.0')
        params[f'{name}_bn0'], stats[f'{name}_bn0'] = t2f_bn(
            sd, f'{base}.0.1')
        params[f'{name}_1'] = conv(f'{base}.1')
    return params, stats


def convert_anchor_head(sd, prefix='dense_head.'):
    """AnchorHeadSingle 1x1 convs (conv_cls, conv_box, conv_dir_cls) plus
    the KL family's conv_box_std and conv_iou where the state dict has
    them."""
    def conv1x1(name):
        return {'kernel': t2f_conv(sd[f'{prefix}{name}.weight']),
                'bias': np.asarray(sd[f'{prefix}{name}.bias'])}
    params = {'conv_cls': conv1x1('conv_cls'),
              'conv_box': conv1x1('conv_box')}
    for extra in ('conv_dir_cls', 'conv_box_std', 'conv_iou'):
        if f'{prefix}{extra}.weight' in sd:
            params[extra] = conv1x1(extra)
    return params, {}


def convert_pfn_layer(sd, prefix=''):
    """PillarVFE's PFNLayer: linear (with a bias only without the norm) and
    its BatchNorm1d `norm` -> Dense_0 and MaskedBatchNorm_0."""
    p = {'Dense_0': {'kernel': t2f_linear(sd[f'{prefix}linear.weight'])}}
    if f'{prefix}linear.bias' in sd:
        p['Dense_0']['bias'] = np.asarray(sd[f'{prefix}linear.bias'])
    bn_p, bn_s = t2f_bn(sd, f'{prefix}norm')
    p['MaskedBatchNorm_0'] = bn_p
    return p, {'MaskedBatchNorm_0': bn_s}


def convert_ddn_deeplabv3(sd, blocks=(3, 4, 23, 3), prefix=''):
    """torchvision deeplabv3_resnet{50,101} state dict (backbone.conv1 /
    bn1, backbone.layer<l>.<b>.conv<k> / bn<k> / downsample.{0,1}, the
    DeepLabHead at classifier.0 (ASPP: convs.0-3 conv + bn, convs.4 the
    pool branch, project), classifier.1-2 (3 x 3 conv + bn), classifier.4
    (1 x 1 conv with bias)) -> {key of models/ddn_deeplab.DDNDeepLabV3:
    array}, layouts unchanged; num_batches_tracked and the aux classifier
    are not read."""
    out = {}

    def conv(dst, src, bias=False):
        out[f'{dst}.weight'] = np.asarray(sd[f'{prefix}{src}.weight'])
        if bias:
            out[f'{dst}.bias'] = np.asarray(sd[f'{prefix}{src}.bias'])

    def bn(dst, src):
        for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
            out[f'{dst}.BatchNorm_0.{leaf}'] = np.asarray(
                sd[f'{prefix}{src}.{leaf}'])

    conv('backbone.conv1', 'backbone.conv1')
    bn('backbone.bn1', 'backbone.bn1')
    for li, n in enumerate(blocks, start=1):
        for bi in range(n):
            src, dst = f'backbone.layer{li}.{bi}', f'backbone.layer{li}_{bi}'
            for ci in (1, 2, 3):
                conv(f'{dst}.conv{ci}', f'{src}.conv{ci}')
                bn(f'{dst}.bn{ci}', f'{src}.bn{ci}')
            if bi == 0:
                conv(f'{dst}.downsample_conv', f'{src}.downsample.0')
                bn(f'{dst}.downsample_bn', f'{src}.downsample.1')
    for i in range(4):
        conv(f'aspp.conv{i}', f'classifier.0.convs.{i}.0')
        bn(f'aspp.bn{i}', f'classifier.0.convs.{i}.1')
    conv('aspp.conv_pool', 'classifier.0.convs.4.1')
    bn('aspp.bn_pool', 'classifier.0.convs.4.2')
    conv('aspp.project', 'classifier.0.project.0')
    bn('aspp.project_bn', 'classifier.0.project.1')
    conv('head_conv', 'classifier.1')
    bn('head_bn', 'classifier.2')
    conv('head_out', 'classifier.4', bias=True)
    return out


def convert_fc_stack(sd, prefix, n_layers, our_name, with_final=None):
    """RoIHeadTemplate.make_fc_layers Sequential [Conv1d, BN, ReLU]*n +
    final Conv1d -> {our_name}_{i} Dense + {our_name}_bn{i} pairs and an
    optional final Dense named `with_final`."""
    params, stats = {}, {}
    seq = 0
    for i in range(n_layers):
        w = np.asarray(sd[f'{prefix}.{seq}.weight'])   # (O, I, 1) conv1d
        params[f'{our_name}_{i}'] = {'kernel': t2f_linear(w[:, :, 0])}
        bn_p, bn_s = t2f_bn(sd, f'{prefix}.{seq + 1}')
        params[f'{our_name}_bn{i}'] = bn_p
        stats[f'{our_name}_bn{i}'] = bn_s
        seq += 3
    if with_final is not None:
        w = np.asarray(sd[f'{prefix}.{seq}.weight'])
        params[with_final] = {
            'kernel': t2f_linear(w[:, :, 0]),
            'bias': np.asarray(sd[f'{prefix}.{seq}.bias'])}
    return params, stats


def convert_voxel_query_pool(sd, prefix):
    """One NeighborVoxelSAModuleMSG -> VoxelQueryPool: mlps_in.0
    (Conv1d + BN1d), mlps_pos.0 (Conv2d 1x1 + BN2d), mlps_out.0 (Conv1d +
    BN1d)."""
    def lin_of_conv(key):
        w = np.asarray(sd[key])          # (O, I, 1) or (O, I, 1, 1)
        return t2f_linear(w.reshape(w.shape[0], w.shape[1]))

    params, stats = {}, {}
    for tname, ours in (('mlps_in', 'in'), ('mlps_pos', 'pos'),
                        ('mlps_out', 'out')):
        params[f'mlp_{ours}'] = {
            'kernel': lin_of_conv(f'{prefix}{tname}.0.0.weight')}
        bn_p, bn_s = t2f_bn(sd, f'{prefix}{tname}.0.1')
        params[f'bn_{ours}'] = bn_p
        stats[f'bn_{ours}'] = bn_s
    return params, stats


def _torch_seq_fc(sd, prefix, our_name):
    """Walk a reference make-fc Sequential (Linear / BN1d / ReLU
    [/ Dropout]) by probing indices; emits {our_name}_{i} Dense +
    {our_name}_bn{i} BN pairs."""
    params, stats = {}, {}
    i = 0
    seq = 0
    while f'{prefix}.{seq}.weight' in sd or \
            f'{prefix}.{seq + 1}.weight' in sd:
        if f'{prefix}.{seq}.weight' not in sd:   # skip a Dropout slot
            seq += 1
            continue
        params[f'{our_name}_{i}'] = {
            'kernel': t2f_linear(sd[f'{prefix}.{seq}.weight'])}
        bn_p, bn_s = t2f_bn(sd, f'{prefix}.{seq + 1}')
        params[f'{our_name}_bn{i}'] = bn_p
        stats[f'{our_name}_bn{i}'] = bn_s
        i += 1
        seq += 3                                  # Linear, BN, ReLU
    return params, stats


def convert_voxelrcnn_kl_head(sd, features_source, prefix='roi_head.'):
    """Reference VoxelRCNNKLLabelIoUHead or VoxelRCNNHead -> VoxelRCNNHead
    in POOL_MODE voxel_query: pool layers (in FEATURES_SOURCE order),
    shared / cls / reg FC stacks, the cls / reg prediction layers, and the
    variance branch (reg_std + BN-ReLU-FC-BN-ReLU-FC) where the state dict
    has it.  Returns (params, batch_stats)."""
    def dense(key, bias=True):
        d = {'kernel': t2f_linear(sd[f'{key}.weight'])}
        if bias and f'{key}.bias' in sd:
            d['bias'] = np.asarray(sd[f'{key}.bias'])
        return d

    params, stats = {}, {}
    for k, src in enumerate(features_source):
        p, s = convert_voxel_query_pool(
            sd, f'{prefix}roi_grid_pool_layers.{k}.')
        params[f'pool_{src}'] = p
        stats[f'pool_{src}'] = s
    for tname, ours in (('shared_fc_layer', 'shared'),
                        ('cls_fc_layers', 'cls_fc'),
                        ('reg_fc_layers', 'reg_fc')):
        p, s = _torch_seq_fc(sd, f'{prefix}{tname}', ours)
        params.update(p)
        stats.update(s)
    params['cls_pred'] = dense(f'{prefix}cls_pred_layer')
    params['reg_pred'] = dense(f'{prefix}reg_pred_layer')
    if f'{prefix}reg_std_layer.weight' in sd:
        params['reg_std'] = dense(f'{prefix}reg_std_layer')
        bn_p, bn_s = t2f_bn(sd, f'{prefix}reg_std_bn')
        params['std_bn0'] = bn_p
        stats['std_bn0'] = bn_s
        params['std_fc1'] = dense(f'{prefix}reg_std_fc1')
        bn_p, bn_s = t2f_bn(sd, f'{prefix}reg_std_bn1')
        params['std_bn1'] = bn_p
        stats['std_bn1'] = bn_s
        params['std_fc2'] = dense(f'{prefix}reg_std_fc2')
    return params, stats


def merge_into(variables, path, params_sub, stats_sub):
    """Graft converted subtrees into a full variables dict (returns a new
    dict; `path` is a tuple of module names from the root)."""
    out = {'params': copy.deepcopy(dict(variables['params'])),
           **{k: copy.deepcopy(dict(v)) for k, v in variables.items()
              if k != 'params'}}

    def set_path(tree, path, sub):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _merge(node.get(path[-1], {}), sub)

    def _merge(dst, src):
        if not isinstance(dst, dict):
            return src
        dst = dict(dst)
        for k, v in src.items():
            dst[k] = _merge(dst.get(k, {}), v) if isinstance(v, dict) else v
        return dst

    set_path(out['params'], path, params_sub)
    if stats_sub:
        out.setdefault('batch_stats', {})
        set_path(out['batch_stats'], path, stats_sub)
    return out


def convert_voxel_backbone_8x(sd, prefix='backbone_3d.',
                              subm_per_block=(2, 2, 2), residual=False):
    """Reference VoxelBackBone8x state_dict -> the backbone subtree:
    conv_input + conv1 (1 subm block) + conv2..4 (strided + subm_per_block
    subm blocks) + conv_out; keys conv{L}.{block}.{0=conv,1=bn} after
    Sequential nesting.  VoxelResBackBone8x (`residual`): conv1 holds 2
    SparseBasicBlocks and conv2..4 a strided conv and 2 of them, each
    block's conv1 / bn1 / conv2 / bn2 -> '<name>a' / '<name>b'."""
    def unit(conv_key, bn_key):
        bn_p, bn_s = t2f_bn(sd, bn_key)
        return ({'kernel': t2f_spconv(sd[conv_key]),
                 'MaskedBatchNorm_0': bn_p},
                {'MaskedBatchNorm_0': bn_s})

    params, stats = {}, {}

    def put(ours, conv_key, bn_key):
        params[ours], stats[ours] = unit(prefix + conv_key, prefix + bn_key)

    def subm(ours, ref):
        if residual:
            put(f'{ours}a', f'{ref}.conv1.weight', f'{ref}.bn1')
            put(f'{ours}b', f'{ref}.conv2.weight', f'{ref}.bn2')
        else:
            put(ours, f'{ref}.0.weight', f'{ref}.1')

    put('conv_input', 'conv_input.0.weight', 'conv_input.1')
    for j in range(2 if residual else 1):
        subm(f'conv1_{j}', f'conv1.{j}')
    for li, lvl in enumerate((2, 3, 4)):
        put(f'conv{lvl}_down', f'conv{lvl}.0.0.weight', f'conv{lvl}.0.1')
        for j in range(subm_per_block[li]):
            subm(f'conv{lvl}_{j}', f'conv{lvl}.{j + 1}')
    put('conv_out', 'conv_out.0.weight', 'conv_out.1')
    return params, stats


def _tracked(state_dict):
    """Wrap a state_dict so key consumption is recorded (for the
    conversion report's `unconsumed` list)."""
    sd = dict(state_dict)
    consumed = set()

    class Tracking(dict):
        def __getitem__(self, k):
            consumed.add(k)
            return sd[k]

        def __contains__(self, k):
            return k in sd

    return Tracking(), sd, consumed


def _finish_report(report, sd, consumed):
    report['unconsumed'] = sorted(
        k for k in sd
        if k not in consumed and 'num_batches_tracked' not in k)
    return report


def _require(cond, family):
    if not cond:
        raise NotImplementedError(f'no conversion for {family} in the port')


# BACKBONE_3D name -> (subm_per_block, residual)
_BB3D_VARIANTS = {'VoxelBackBone8x': ((2, 2, 2), False),
                  'VoxelBackBone8xCiassd': ((2, 3, 3), False),
                  'VoxelResBackBone8x': ((2, 2, 2), True)}
_DENSE_HEADS = ('AnchorHeadSingle', 'AnchorHeadKLLabel', 'AnchorHeadKL',
                'AnchorHeadKLLabelIoU', 'AnchorHeadKLLabelIoUGuide',
                'AnchorHeadIoU', 'CenterHead')
# MODEL name -> the ROI_HEAD names it may have (None: none); SECONDHead's
# keys, and PV-RCNN's and PV-RCNN++'s pfe.*, point_head.* and roi_head.*
# keys, are not converted (as in glenet_tpu) and land in `unconsumed`
_ROI_HEADS = {'VoxelRCNN': ('VoxelRCNNKLLabelIoUHead', 'VoxelRCNNHead'),
              'SECONDNetIoU': ('SECONDHead',), 'SECONDNet': (None,),
              'PointPillar': (None,), 'PVRCNN': ('PVRCNNHead',),
              'PVRCNNPlusPlus': ('PVRCNNHead',), 'CenterPoint': (None,)}


def convert_full_model(cfg, state_dict, variables):
    """Full-model reference -> variables conversion: MeanVFE or DynMeanVFE
    (no parameters) with VoxelBackBone8x, VoxelBackBone8xCiassd or
    VoxelResBackBone8x, or PillarVFE's PFN layers, then BaseBEVBackbone or
    SSFA, the anchor head (with conv_box_std / conv_iou where the state
    dict has them) or CenterHead and, in VoxelRCNN with POOL_MODE
    voxel_query, the roi
    head (see the module docstring for corner mode).  `variables` is the
    template: a full {'params', 'batch_stats'} tree whose leaves the
    converted ones replace.  Any other family raises NotImplementedError
    before it reads a key.

    Returns (variables, report): report['converted'] lists the converted
    subtrees, report['unconsumed'] the reference keys that had no
    destination (num_batches_tracked left out)."""
    mcfg = cfg.MODEL
    name = mcfg.get('NAME')
    # CaDDN's camera VFE has no conversion, as in glenet_tpu
    _require((mcfg.get('VFE') or {}).get('NAME') != 'ImageVFE',
             'VFE ImageVFE')
    _require(name in _ROI_HEADS, f'MODEL {name}')
    vfe = mcfg.VFE.NAME
    pillars = vfe == 'PillarVFE'
    _require(vfe in ('PillarVFE', 'MeanVFE', 'DynMeanVFE', 'DynamicMeanVFE'),
             f'VFE {vfe}')
    _require(pillars == (name == 'PointPillar') or name == 'CenterPoint',
             f'VFE {vfe} in {name}')
    bb3d = mcfg.get('BACKBONE_3D', {}).get('NAME')
    _require(bb3d is None if pillars else bb3d in _BB3D_VARIANTS,
             f'BACKBONE_3D {bb3d}')
    bb2d = mcfg.get('BACKBONE_2D', {}).get('NAME')
    _require(bb2d in ('BaseBEVBackbone', 'SSFA'), f'BACKBONE_2D {bb2d}')
    _require(mcfg.DENSE_HEAD.NAME in _DENSE_HEADS,
             f'DENSE_HEAD {mcfg.DENSE_HEAD.NAME}')
    roi_cfg = mcfg.get('ROI_HEAD', None)
    roi_name = roi_cfg.NAME if roi_cfg is not None else None
    _require(roi_name in _ROI_HEADS[name], f'ROI_HEAD {roi_name}')

    tsd, sd, consumed = _tracked(state_dict)
    merged = variables
    report = {'converted': []}

    if pillars:
        vfe_p, vfe_s = {}, {}
        i = 0
        while f'vfe.pfn_layers.{i}.linear.weight' in sd:
            vfe_p[f'PFNLayer_{i}'], vfe_s[f'PFNLayer_{i}'] = \
                convert_pfn_layer(tsd, prefix=f'vfe.pfn_layers.{i}.')
            i += 1
        if i == 0:
            raise KeyError('no vfe.pfn_layers.* keys found')
        merged = merge_into(merged, ('vfe',), vfe_p, vfe_s)
        report['converted'].append('vfe')
    else:
        subm, residual = _BB3D_VARIANTS[bb3d]
        bb3d_p, bb3d_s = convert_voxel_backbone_8x(
            tsd, subm_per_block=subm, residual=residual)
        merged = merge_into(merged, ('backbone_3d',), bb3d_p, bb3d_s)
        report['converted'].append('backbone_3d')

    if bb2d == 'SSFA':
        perm = height_compression_perm(
            sd, 'backbone_2d.bottom_up_block_0.1.weight')
        bb2d_p, bb2d_s = convert_ssfa(tsd, in_perm=perm)
    else:
        layer_nums = list(mcfg.BACKBONE_2D.LAYER_NUMS)
        upsample = bool(mcfg.BACKBONE_2D.get('UPSAMPLE_STRIDES', []))
        perm = height_compression_perm(sd, 'backbone_2d.blocks.0.1.weight')
        bb2d_p, bb2d_s = convert_base_bev_backbone(
            tsd, layer_nums, upsample=upsample, prefix='backbone_2d.',
            in_perm=perm)
    merged = merge_into(merged, ('backbone_2d',), bb2d_p, bb2d_s)
    report['converted'].append('backbone_2d')

    dh_p, dh_s = (convert_center_head(tsd)
                  if mcfg.DENSE_HEAD.NAME == 'CenterHead'
                  else convert_anchor_head(tsd))
    merged = merge_into(merged, ('dense_head',), dh_p, dh_s)
    report['converted'].append('dense_head')

    if (roi_cfg is not None
            and str(roi_cfg.get('ROI_GRID_POOL', {}).get(
                'POOL_MODE', 'corner')) == 'voxel_query'
            and 'roi_head.shared_fc_layer.0.weight' in sd):
        rh_p, rh_s = convert_voxelrcnn_kl_head(
            tsd, list(roi_cfg.ROI_GRID_POOL.FEATURES_SOURCE))
        merged = merge_into(merged, ('roi_head',), rh_p, rh_s)
        report['converted'].append('roi_head')

    return merged, _finish_report(report, sd, consumed)
