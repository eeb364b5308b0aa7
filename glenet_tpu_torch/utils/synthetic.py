"""Synthetic inputs and seeded random weights for runs on the card
(chip_smoke.py, profile_predict.py, profile_train.py) and for the CPU
tests: no trained checkpoint and no KITTI, Waymo, nuScenes, Lyft or
Pandaset data are in the repository."""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from ..models.ddn_deeplab import BatchNorm
from ..models.detectors import build_detector
from ..models.layers import MaskedBatchNorm
from ..models.spconv_backbone import VARIANTS
from ..config import DATASET_YAMLS, NUSCENES_CLASSES, repo_yaml
from . import box_utils, calibration_kitti, common, png

N_POINTS = 32768
MAX_GT_PER_SCENE = 128      # KITTI's gt slots per scene


def make_scene(rng, n_points=N_POINTS):
    """Clustered KITTI-like scene: ground plane + car-sized clusters (the
    generator of the JAX package's tools/bench_model.py)."""
    return _scene_and_clusters(rng, n_points)[0]


def _scene_and_clusters(rng, n_points):
    """make_scene's points and the (x, y) centres of its clusters."""
    centres = []
    n_ground = int(n_points * 0.55)
    pts = np.zeros((n_points, 4), np.float32)
    pts[:n_ground, 0] = rng.uniform(0, 69.12, n_ground)
    pts[:n_ground, 1] = rng.uniform(-39.68, 39.68, n_ground)
    pts[:n_ground, 2] = rng.normal(-1.6, 0.1, n_ground)
    i = n_ground
    while i < n_points:
        n = min(rng.randint(200, 1500), n_points - i)
        cx, cy = rng.uniform(5, 60), rng.uniform(-30, 30)
        centres.append((cx, cy))
        pts[i:i + n, 0] = cx + rng.normal(0, 1.5, n)
        pts[i:i + n, 1] = cy + rng.normal(0, 0.8, n)
        pts[i:i + n, 2] = rng.uniform(-1.6, 0.2, n)
        i += n
    pts[:, 3] = rng.uniform(0, 1, n_points)
    return pts, centres


def scene_batches(n, seed=0, batch=2, device='cuda', n_points=N_POINTS):
    """`n` predict requests of `batch` scenes each, drawn in order from one
    RandomState(seed): {'points', 'points_mask'} on `device`."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pts = torch.from_numpy(np.stack([make_scene(rng, n_points)
                                         for _ in range(batch)])).to(device)
        out.append({'points': pts,
                    'points_mask': torch.ones(pts.shape[:2], dtype=torch.bool,
                                              device=device)})
    return out


def train_batches(n, seed=0, batch=4, device='cuda', n_points=N_POINTS):
    """`n` training batches of `batch` scenes each, all from one
    RandomState(seed): make_scene's points plus one Car gt box per cluster
    (centre, 3.9 x 1.6 x 1.56 m, bottom at the ground, heading within
    +-0.3 rad of the cluster's long x axis) in MAX_GT_PER_SCENE slots, with
    gt_mask and a positive gt_uncertainty (B, 128, 7) of label variances in
    [0.01, 0.2)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pts = np.zeros((batch, n_points, 4), np.float32)
        gt = np.zeros((batch, MAX_GT_PER_SCENE, 8), np.float32)
        gt_mask = np.zeros((batch, MAX_GT_PER_SCENE), bool)
        unc = np.ones((batch, MAX_GT_PER_SCENE, 7), np.float32)
        for b in range(batch):
            pts[b], centres = _scene_and_clusters(rng, n_points)
            k = min(len(centres), MAX_GT_PER_SCENE)
            gt[b, :k, :2] = centres[:k]
            gt[b, :k, 2:7] = [-1.6 + 1.56 / 2, 3.9, 1.6, 1.56, 0.0]
            gt[b, :k, 6] = rng.uniform(-0.3, 0.3, k)
            gt[b, :k, 7] = 1
            gt_mask[b, :k] = True
            unc[b, :k] = rng.uniform(0.01, 0.2, (k, 7))
        out.append({k: torch.from_numpy(v).to(device) for k, v in (
            ('points', pts), ('points_mask', np.ones(pts.shape[:2], bool)),
            ('gt_boxes', gt), ('gt_mask', gt_mask),
            ('gt_uncertainty', unc))})
    return out


# Labelled objects per class over KITTI's 7481 training frames (Geiger,
# Lenz and Urtasun, CVPR 2012: the KITTI object detection benchmark's
# label_2 files): the ratios at which the three-class scenes and trees
# here place Pedestrians and Cyclists beside Cars.
KITTI_LABEL_COUNTS = {'Car': 28742, 'Pedestrian': 4487, 'Cyclist': 1627}
# (dx, dy, dz) ranges of each class's boxes, metres; the anchors of the
# three-class configs (second.yaml, pointpillar.yaml) lie inside them
KITTI_SIZES = {'Car': ((3.4, 4.6), (1.5, 1.9), (1.4, 1.8)),
               'Pedestrian': ((0.6, 1.0), (0.5, 0.8), (1.5, 1.9)),
               'Cyclist': ((1.5, 1.9), (0.5, 0.8), (1.6, 1.9))}
# points inside one object of each class (a range drawn uniformly)
KITTI_OBJECT_POINTS = {'Car': (300, 1500), 'Pedestrian': (80, 400),
                       'Cyclist': (80, 400)}


def _three_class_scene(rng, n_points):
    """make_scene's ground (55% of the points), then objects until the
    points run out, each of a class drawn by KITTI_LABEL_COUNTS: its box
    (KITTI_SIZES, on the ground, heading within +-0.3 rad) filled with
    KITTI_OBJECT_POINTS points.  Returns (points (n_points, 4), boxes
    (K, 7), labels (K,) 1-based in KITTI_LABEL_COUNTS' order)."""
    names = list(KITTI_LABEL_COUNTS)
    p = np.array([KITTI_LABEL_COUNTS[n] for n in names], np.float64)
    n_ground = int(n_points * 0.55)
    pts = np.zeros((n_points, 4), np.float32)
    pts[:n_ground, 0] = rng.uniform(0, 69.12, n_ground)
    pts[:n_ground, 1] = rng.uniform(-39.68, 39.68, n_ground)
    pts[:n_ground, 2] = rng.normal(-1.6, 0.1, n_ground)
    boxes, labels = [], []
    i = n_ground
    while i < n_points:
        c = rng.choice(len(names), p=p / p.sum())
        dims = [rng.uniform(*r) for r in KITTI_SIZES[names[c]]]
        n = min(rng.randint(*KITTI_OBJECT_POINTS[names[c]]), n_points - i)
        box = [rng.uniform(5, 60), rng.uniform(-30, 30),
               -1.6 + dims[2] / 2, *dims, rng.uniform(-0.3, 0.3)]
        local = rng.uniform(-0.5, 0.5, (n, 3)) * dims
        pts[i:i + n, :3] = common.rotate_points_along_z_np(
            local, np.array([box[6]])) + box[:3]
        boxes.append(box)
        labels.append(c + 1)
        i += n
    pts[:, 3] = rng.uniform(0, 1, n_points)
    return pts, np.array(boxes, np.float32), np.array(labels)


def three_class_train_batches(n, seed=0, batch=4, device='cuda',
                              n_points=N_POINTS):
    """`n` training batches of `batch` three-class scenes each
    (_three_class_scene), all from one RandomState(seed): every object's
    box and class in MAX_GT_PER_SCENE slots, with gt_mask and label
    variances in [0.01, 0.2)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pts = np.zeros((batch, n_points, 4), np.float32)
        gt = np.zeros((batch, MAX_GT_PER_SCENE, 8), np.float32)
        gt_mask = np.zeros((batch, MAX_GT_PER_SCENE), bool)
        unc = np.ones((batch, MAX_GT_PER_SCENE, 7), np.float32)
        for b in range(batch):
            pts[b], boxes, labels = _three_class_scene(rng, n_points)
            k = min(len(boxes), MAX_GT_PER_SCENE)
            gt[b, :k, :7] = boxes[:k]
            gt[b, :k, 7] = labels[:k]
            gt_mask[b, :k] = True
            unc[b, :k] = rng.uniform(0.01, 0.2, (k, 7))
        out.append({k: torch.from_numpy(v).to(device) for k, v in (
            ('points', pts), ('points_mask', np.ones(pts.shape[:2], bool)),
            ('gt_boxes', gt), ('gt_mask', gt_mask),
            ('gt_uncertainty', unc))})
    return out


def seeded_detector(cfg, device, seed):
    """Detector with weights drawn from `seed`, BN statistics included (so
    BN is not an identity)."""
    torch.manual_seed(seed)
    det = build_detector(cfg, device='cpu')
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in det.net.modules():
            if isinstance(m, (MaskedBatchNorm, BatchNorm)):
                n = m.weight.shape[0]
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
    if device != 'cpu':
        state = det.net.state_dict()
        det = build_detector(cfg, device=device)
        det.net.load_state_dict(state)
    return det


# ---------------------------------------------------------------------------
# a reference (pcdet) checkpoint of random tensors
# ---------------------------------------------------------------------------

def _pcdet_backbone(subm_per_block, out_channels, channels, residual):
    """VoxelBackBone8x(Ciassd) or VoxelResBackBone8x: (conv, its BN, cin,
    cout, kernel (kz, ky, kx)) of each spconv layer in the reference's
    module order; a residual SparseBasicBlock `conv<L>.<j>` holds conv1 /
    bn1 / conv2 / bn2."""
    k3 = (3, 3, 3)

    def subm(name, c):
        if residual:
            return [(f'{name}.conv{i}', f'{name}.bn{i}', c, c, k3)
                    for i in (1, 2)]
        return [(f'{name}.0', f'{name}.1', c, c, k3)]

    c1 = channels[0]
    layers = [('conv_input.0', 'conv_input.1', 'in', c1, k3)]
    for j in range(2 if residual else 1):
        layers += subm(f'conv1.{j}', c1)
    for lvl, cin, c, n in zip((2, 3, 4), channels[:3], channels[1:],
                              subm_per_block):
        layers.append((f'conv{lvl}.0.0', f'conv{lvl}.0.1', cin, c, k3))
        for j in range(1, n + 1):
            layers += subm(f'conv{lvl}.{j}', c)
    return layers + [('conv_out.0', 'conv_out.1', channels[3], out_channels,
                      (3, 1, 1))]


def pcdet_state_dict(cfg, seed=0, num_point_features=None):
    """A state dict of random tensors under the key names and layouts of
    the reference (OpenPCDet / GLENet) for `cfg`, VoxelRCNN, SECONDNet,
    SECONDNetIoU, PointPillar, PVRCNN, PVRCNNPlusPlus or CenterPoint:
    MeanVFE or
    DynMeanVFE (no parameters) or PillarVFE (vfe.pfn_layers.{i}.linear
    without bias and .norm), VoxelBackBone8x, VoxelBackBone8xCiassd or
    VoxelResBackBone8x (its SparseBasicBlocks' conv1 / bn1 / conv2 / bn2)
    (spconv 2.x weights (O, kz, ky, kx, I); conv{L}.{block}.{0 conv, 1
    BN}), BaseBEVBackbone (blocks.{i} = ZeroPad, Conv, BN, ReLU, then Conv,
    BN, ReLU per layer; deblocks.{i} = ConvTranspose2d (I, O, k, k), BN,
    ReLU) or SSFA (bottom_up_block_0 = ZeroPad then 3 x Conv, BN, ReLU;
    bottom_up_block_1 = 3 x Conv, BN, ReLU, the first of stride 2; trans_0
    / trans_1 / conv_0 / conv_1 / w_0 / w_1 = Conv, BN (ReLU);
    deconv_block_{i} = ConvTranspose2d (256, 128, 3, 3), BN, ReLU; no conv
    biases), the anchor head (1x1 conv_cls / conv_box / conv_dir_cls with
    biases, conv_box_std for AnchorHeadKLLabel and conv_iou for
    AnchorHeadKLLabelIoU) or CenterHead (shared_conv and heads_list.0.
    <name> of 3x3 convs, biases before the BNs with USE_BIAS_BEFORE_NORM),
    and in VoxelRCNN the roi head:
    roi_grid_pool_layers.{k} NeighborVoxelSAModuleMSG (mlps_in.0 Conv1d +
    BN1d, mlps_pos.0 Conv2d 1x1 + BN2d, mlps_out.0 Conv1d + BN1d), the
    shared_fc_layer / cls_fc_layers / reg_fc_layers stacks of Linear, BN1d,
    ReLU (and Dropout after every Linear but the last when DP_RATIO > 0),
    cls_pred_layer, reg_pred_layer and, for VoxelRCNNKLLabelIoUHead,
    reg_std_layer, reg_std_bn, reg_std_fc1, reg_std_bn1 and reg_std_fc2;
    in SECONDNetIoU the roi head of _pcdet_second_head, in PVRCNN and
    PVRCNNPlusPlus the stage 2 of _pcdet_pvrcnn_stage2.
    Every BN comes with running stats and num_batches_tracked.  Weights ~
    N(0, 1/fan_in), biases and running means ~ N(0, 0.1), BN scales and
    running variances ~ U(0.5, 1.5).  The input convolution takes
    `num_point_features` channels, by default those of the config's
    used_feature_list (5 on Waymo), else 4.  Returns {key: CPU tensor}."""
    from ..ops import sparse
    from ..ops import voxelize as vox_ops
    rng = np.random.RandomState(seed)
    mcfg = cfg.MODEL
    sd = {}
    if num_point_features is None:
        enc = cfg.DATA_CONFIG.get('POINT_FEATURE_ENCODING', None)
        num_point_features = (len(enc['used_feature_list'])
                              if enc is not None else 4)

    def weight(key, shape, fan_in):
        sd[key] = rng.randn(*shape) / np.sqrt(fan_in)

    def bias(key, n):
        sd[key] = rng.randn(n) * 0.1

    def bn(prefix, n):
        sd[f'{prefix}.weight'] = rng.uniform(0.5, 1.5, n)
        bias(f'{prefix}.bias', n)
        bias(f'{prefix}.running_mean', n)
        sd[f'{prefix}.running_var'] = rng.uniform(0.5, 1.5, n)
        sd[f'{prefix}.num_batches_tracked'] = np.array(1000, np.int64)

    if mcfg.VFE.NAME == 'PillarVFE':
        vfe = mcfg.VFE
        cin = num_point_features + (6 if vfe.get('USE_ABSLOTE_XYZ', True)
                                    else 3)
        cin += int(vfe.get('WITH_DISTANCE', False))
        filters = list(vfe.NUM_FILTERS)
        for i, f in enumerate(filters):
            out = f if i == len(filters) - 1 else f // 2
            weight(f'vfe.pfn_layers.{i}.linear.weight', (out, cin), cin)
            bn(f'vfe.pfn_layers.{i}.norm', out)
            cin = f
        c_in = filters[-1]
    else:
        for conv, bn_key, cin, cout, k in _pcdet_backbone(
                *VARIANTS[mcfg.BACKBONE_3D.NAME]):
            cin = num_point_features if cin == 'in' else cin
            weight(f'backbone_3d.{conv}.weight', (cout, *k, cin),
                   cin * int(np.prod(k)))
            bn(f'backbone_3d.{bn_key}', cout)
        c_out = VARIANTS[mcfg.BACKBONE_3D.NAME][1]

        # the BEV depth after conv_out, as the reference's dense() gives it
        proc = {p.NAME: p for p in cfg.DATA_CONFIG.DATA_PROCESSOR}
        vox_cfg = proc.get('transform_points_to_voxels',
                           proc.get('transform_points_to_voxels_placeholder'))
        grid = vox_ops.compute_grid_size(cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                                         vox_cfg.VOXEL_SIZE)
        g = (grid[0], grid[1], grid[2] + 1)
        for k, s, p in ((3, 2, 1), (3, 2, 1), (3, 2, (0, 1, 1)),
                        ((3, 1, 1), (2, 1, 1), 0)):
            g = sparse.out_grid_size(g, k, s, p)
        c_in = g[2] * c_out
    c_height = c_in

    bb = mcfg.BACKBONE_2D
    if bb.NAME == 'SSFA':
        convs = [(f'bottom_up_block_0.{1 + 3 * i}', f'bottom_up_block_0.'
                  f'{2 + 3 * i}', c_in if i == 0 else 128, 128, 3)
                 for i in range(3)]
        convs += [(f'bottom_up_block_1.{3 * i}', f'bottom_up_block_1.'
                   f'{3 * i + 1}', 128 if i == 0 else 256, 256, 3)
                  for i in range(3)]
        convs += [(f'{name}.0', f'{name}.1', cin, cout, k)
                  for name, cin, cout, k in (
                      ('trans_0', 128, 128, 1), ('trans_1', 256, 256, 1),
                      ('conv_0', 128, 128, 3), ('conv_1', 128, 128, 3),
                      ('w_0', 128, 1, 1), ('w_1', 128, 1, 1))]
        for conv, bn_key, cin, cout, k in convs:
            weight(f'backbone_2d.{conv}.weight', (cout, cin, k, k),
                   cin * k * k)
            bn(f'backbone_2d.{bn_key}', cout)
        for i in (0, 1):
            weight(f'backbone_2d.deconv_block_{i}.0.weight', (256, 128, 3, 3),
                   256 * 9)
            bn(f'backbone_2d.deconv_block_{i}.1', 128)
        c_bev = 128
    else:
        for i, (n, f) in enumerate(zip(bb.LAYER_NUMS, bb.NUM_FILTERS)):
            weight(f'backbone_2d.blocks.{i}.1.weight', (f, c_in, 3, 3),
                   c_in * 9)
            bn(f'backbone_2d.blocks.{i}.2', f)
            for j in range(n):
                weight(f'backbone_2d.blocks.{i}.{4 + 3 * j}.weight',
                       (f, f, 3, 3), f * 9)
                bn(f'backbone_2d.blocks.{i}.{5 + 3 * j}', f)
            up, s = bb.NUM_UPSAMPLE_FILTERS[i], bb.UPSAMPLE_STRIDES[i]
            weight(f'backbone_2d.deblocks.{i}.0.weight', (f, up, s, s),
                   f * s * s)
            bn(f'backbone_2d.deblocks.{i}.1', up)
            c_in = f
        c_bev = sum(bb.NUM_UPSAMPLE_FILTERS)

    head = mcfg.DENSE_HEAD
    if head.NAME == 'CenterHead':
        _pcdet_center_head(head, len(cfg.CLASS_NAMES), c_bev, weight, bn,
                           bias)
    else:
        _pcdet_anchor_head(head, len(cfg.CLASS_NAMES), c_bev, weight, bias)

    if 'ROI_HEAD' not in mcfg:
        return _tensors(sd)
    roi = mcfg.ROI_HEAD
    if roi.NAME == 'SECONDHead':
        _pcdet_second_head(roi, weight, bn, bias)
        return _tensors(sd)
    if roi.NAME == 'PVRCNNHead':
        _pcdet_pvrcnn_stage2(mcfg, num_point_features, c_height, weight, bn,
                             bias)
        return _tensors(sd)
    pool = roi.ROI_GRID_POOL
    channels = {'x_conv1': 16, 'x_conv2': 32, 'x_conv3': 64, 'x_conv4': 64}
    c_pooled = 0
    for k, src in enumerate(pool.FEATURES_SOURCE):
        mid, out = pool.POOL_LAYERS[src]['MLPS'][0]
        base = f'roi_head.roi_grid_pool_layers.{k}'
        weight(f'{base}.mlps_in.0.0.weight', (mid, channels[src], 1),
               channels[src])
        bn(f'{base}.mlps_in.0.1', mid)
        weight(f'{base}.mlps_pos.0.0.weight', (mid, 3, 1, 1), 3)
        bn(f'{base}.mlps_pos.0.1', mid)
        weight(f'{base}.mlps_out.0.0.weight', (out, mid, 1), mid)
        bn(f'{base}.mlps_out.0.1', out)
        c_pooled += out

    def fc_layers(name, sizes, c):
        seq = 0
        for i, s in enumerate(sizes):
            weight(f'roi_head.{name}.{seq}.weight', (s, c), c)
            bn(f'roi_head.{name}.{seq + 1}', s)
            c = s
            seq += 4 if roi.get('DP_RATIO', 0) > 0 and i < len(sizes) - 1 \
                else 3
        return c

    c_shared = fc_layers('shared_fc_layer', roi.SHARED_FC,
                         c_pooled * int(pool.GRID_SIZE) ** 3)
    for name, sizes, pred, n_out in (('cls_fc_layers', roi.CLS_FC,
                                      'cls_pred_layer', 1),
                                     ('reg_fc_layers', roi.REG_FC,
                                      'reg_pred_layer', 7)):
        c = fc_layers(name, sizes, c_shared)
        weight(f'roi_head.{pred}.weight', (n_out, c), c)
        bias(f'roi_head.{pred}.bias', n_out)
    if 'KLLabel' in roi.NAME:
        c = roi.REG_FC[-1]
        weight('roi_head.reg_std_layer.weight', (7, c), c)
        bias('roi_head.reg_std_layer.bias', 7)
        bn('roi_head.reg_std_bn', 7)
        weight('roi_head.reg_std_fc1.weight', (64, 7), 7)
        bias('roi_head.reg_std_fc1.bias', 64)
        bn('roi_head.reg_std_bn1', 64)
        weight('roi_head.reg_std_fc2.weight', (1, 64), 64)
        bias('roi_head.reg_std_fc2.bias', 1)
    return _tensors(sd)


def _pcdet_anchor_head(head, n_class, c_bev, weight, bias):
    """The anchor head's 1x1 convs with biases: conv_cls, conv_box,
    conv_dir_cls with a direction classifier, conv_box_std
    (AnchorHeadKLLabel, AnchorHeadKLLabelIoU), conv_iou
    (AnchorHeadKLLabelIoU)."""
    n_anchors = sum(len(a['anchor_sizes']) * len(a['anchor_rotations'])
                    * len(a['anchor_bottom_heights'])
                    for a in head.ANCHOR_GENERATOR_CONFIG)
    outs = {'conv_cls': n_class, 'conv_box': 7}
    if head.get('USE_DIRECTION_CLASSIFIER', False):
        outs['conv_dir_cls'] = head.NUM_DIR_BINS
    if head.NAME in ('AnchorHeadKLLabel', 'AnchorHeadKLLabelIoU'):
        outs['conv_box_std'] = 7
    if head.NAME == 'AnchorHeadKLLabelIoU':
        outs['conv_iou'] = n_class
    for name, per_anchor in outs.items():
        weight(f'dense_head.{name}.weight', (n_anchors * per_anchor, c_bev,
                                             1, 1), c_bev)
        bias(f'dense_head.{name}.bias', n_anchors * per_anchor)


def _pcdet_center_head(head, n_class, c_bev, weight, bn, bias):
    """CenterHead's keys: shared_conv (3x3 Conv, BN), then per branch
    heads_list.0.<name>: .0.0 3x3 Conv, .0.1 BN and .1 the biased 3x3
    output conv; the convs before a BN carry a bias with
    USE_BIAS_BEFORE_NORM."""
    ch = int(head.get('SHARED_CONV_CHANNEL', 64))
    with_bias = head.get('USE_BIAS_BEFORE_NORM', False)

    def conv(key, cin, cout, biased):
        weight(f'{key}.weight', (cout, cin, 3, 3), cin * 9)
        if biased:
            bias(f'{key}.bias', cout)

    conv('dense_head.shared_conv.0', c_bev, ch, with_bias)
    bn('dense_head.shared_conv.1', ch)
    for name, out in (('hm', n_class), ('center', 2), ('center_z', 1),
                      ('dim', 3), ('rot', 2)):
        base = f'dense_head.heads_list.0.{name}'
        conv(f'{base}.0.0', ch, ch, with_bias)
        bn(f'{base}.0.1', ch)
        conv(f'{base}.1', ch, out, True)


def _pcdet_second_head(roi, weight, bn, bias):
    """SECONDHead's keys: shared_fc_layer (Conv1d k1 without bias, BN1d,
    ReLU per SHARED_FC entry, a Dropout after each but the last when
    DP_RATIO > 0) and iou_layers (RoIHeadTemplate.make_fc_layers: the same
    per IOU_FC entry with a Dropout after the first when DP_RATIO >= 0,
    then a Conv1d k1 with bias to one output)."""
    pool = roi.ROI_GRID_POOL
    c = int(pool.IN_CHANNEL) * int(pool.GRID_SIZE) ** 2
    seq = 0
    for k, f in enumerate(roi.SHARED_FC):
        weight(f'roi_head.shared_fc_layer.{seq}.weight', (f, c, 1), c)
        bn(f'roi_head.shared_fc_layer.{seq + 1}', f)
        c = f
        seq += 4 if k < len(roi.SHARED_FC) - 1 and roi.DP_RATIO > 0 else 3
    seq = 0
    for k, f in enumerate(roi.IOU_FC):
        weight(f'roi_head.iou_layers.{seq}.weight', (f, c, 1), c)
        bn(f'roi_head.iou_layers.{seq + 1}', f)
        c = f
        seq += 4 if k == 0 and roi.DP_RATIO >= 0 else 3
    weight(f'roi_head.iou_layers.{seq}.weight', (1, c, 1), c)
    bias(f'roi_head.iou_layers.{seq}.bias', 1)


def _pcdet_pvrcnn_stage2(mcfg, num_point_features, c_bev, weight, bn, bias):
    """PV-RCNN's and PV-RCNN++'s stage-2 keys: pfe.SA_layers.{k} (the
    backbone levels of FEATURES_SOURCE in order) and pfe.SA_rawpoints, each
    mlps.{i} = Conv2d 1x1 without bias, BN2d, ReLU per MLPS entry (on 3 + C
    inputs), or for a VectorPoolAggregationModuleMSG source layer_{g} per
    group (separate_local_aggregation_layer = Conv1d k1 with G groups
    without bias, BN1d, ReLU; post_mlps.{3i} = Conv1d k1 without bias,
    BN1d, ReLU per POST_MLPS entry) and msg_post_mlps (the same per
    MSG_POST_MLPS entry over the groups and xyz);
    pfe.vsa_point_feature_fusion (Linear without bias, BN1d);
    point_head.cls_layers (Linear without bias, BN1d, ReLU per CLS_FC
    entry, then a Linear with bias); roi_head.roi_grid_pool_layer as the
    SA or VectorPool layers, shared_fc_layer (Conv1d k1 without bias,
    BN1d, ReLU per SHARED_FC entry, a Dropout after each but the last when
    DP_RATIO > 0), cls_layers and reg_layers (RoIHeadTemplate.
    make_fc_layers: the same per entry, a Dropout after the first when
    DP_RATIO >= 0, then a Conv1d k1 with bias)."""
    channels = {'x_conv1': 16, 'x_conv2': 32, 'x_conv3': 64, 'x_conv4': 64,
                'raw_points': num_point_features - 3}

    def conv1d_stack(prefix, c, sizes):
        for i, f in enumerate(sizes):
            weight(f'{prefix}.{3 * i}.weight', (f, c, 1), c)
            bn(f'{prefix}.{3 * i + 1}', f)
            c = f
        return c

    def vector_pool_layer(prefix, cin, cfg_s):
        c_msg = 3
        g_out = int(cfg_s.NUM_CHANNELS_OF_LOCAL_AGGREGATION)
        reduced = int(cfg_s.get('NUM_REDUCED_CHANNELS') or cin)
        extra = 9 if cfg_s.LOCAL_AGGREGATION_TYPE == 'local_interpolation' \
            else 3
        for k in range(int(cfg_s.NUM_GROUPS)):
            gcfg = cfg_s[f'GROUP_CFG_{k}']
            g = int(np.prod(gcfg.NUM_LOCAL_VOXEL))
            base = f'{prefix}.layer_{k}'
            weight(f'{base}.separate_local_aggregation_layer.0.weight',
                   (g * g_out, reduced + extra, 1), reduced + extra)
            bn(f'{base}.separate_local_aggregation_layer.1', g * g_out)
            c_msg += conv1d_stack(f'{base}.post_mlps', g * g_out,
                                  gcfg.POST_MLPS)
        return conv1d_stack(f'{prefix}.msg_post_mlps', c_msg,
                            cfg_s.get('MSG_POST_MLPS') or ())

    def sa_layer(prefix, cin, cfg_s):
        if cfg_s.get('NAME') == 'VectorPoolAggregationModuleMSG':
            return vector_pool_layer(prefix, cin, cfg_s)
        c_out = 0
        for i, m in enumerate(cfg_s.MLPS):
            c = cin + 3
            for j, f in enumerate(m):
                weight(f'{prefix}.mlps.{i}.{3 * j}.weight', (f, c, 1, 1), c)
                bn(f'{prefix}.mlps.{i}.{3 * j + 1}', f)
                c = f
            c_out += c
        return c_out

    pfe = mcfg.PFE
    c_fused = c_bev if 'bev' in pfe.FEATURES_SOURCE else 0
    levels = [s for s in pfe.FEATURES_SOURCE
              if s not in ('bev', 'raw_points')]
    for k, src in enumerate(levels):
        c_fused += sa_layer(f'pfe.SA_layers.{k}', channels[src],
                            pfe.SA_LAYER[src])
    if 'raw_points' in pfe.FEATURES_SOURCE:
        c_fused += sa_layer('pfe.SA_rawpoints', channels['raw_points'],
                            pfe.SA_LAYER['raw_points'])
    c_kp = int(pfe.NUM_OUTPUT_FEATURES)
    weight('pfe.vsa_point_feature_fusion.0.weight', (c_kp, c_fused), c_fused)
    bn('pfe.vsa_point_feature_fusion.1', c_kp)
    c = c_fused
    for j, f in enumerate(mcfg.POINT_HEAD.CLS_FC):
        weight(f'point_head.cls_layers.{3 * j}.weight', (f, c), c)
        bn(f'point_head.cls_layers.{3 * j + 1}', f)
        c = f
    n = 3 * len(mcfg.POINT_HEAD.CLS_FC)
    weight(f'point_head.cls_layers.{n}.weight', (1, c), c)
    bias(f'point_head.cls_layers.{n}.bias', 1)

    roi = mcfg.ROI_HEAD
    pool = roi.ROI_GRID_POOL
    c = sa_layer('roi_head.roi_grid_pool_layer', c_kp, pool) * int(
        pool.GRID_SIZE) ** 3
    seq = 0
    for k, f in enumerate(roi.SHARED_FC):
        weight(f'roi_head.shared_fc_layer.{seq}.weight', (f, c, 1), c)
        bn(f'roi_head.shared_fc_layer.{seq + 1}', f)
        c = f
        seq += 4 if k < len(roi.SHARED_FC) - 1 and roi.DP_RATIO > 0 else 3
    c_shared = c
    for name, sizes, n_out in (('cls_layers', roi.CLS_FC, 1),
                               ('reg_layers', roi.REG_FC, 7)):
        c, seq = c_shared, 0
        for k, f in enumerate(sizes):
            weight(f'roi_head.{name}.{seq}.weight', (f, c, 1), c)
            bn(f'roi_head.{name}.{seq + 1}', f)
            c = f
            seq += 4 if k == 0 and roi.DP_RATIO >= 0 else 3
        weight(f'roi_head.{name}.{seq}.weight', (n_out, c, 1), c)
        bias(f'roi_head.{name}.{seq}.bias', n_out)


def _tensors(sd):
    return {k: torch.from_numpy(np.asarray(
        v, np.int64 if k.endswith('num_batches_tracked') else np.float32))
        for k, v in sd.items()}


# ---------------------------------------------------------------------------
# a synthetic data tree in KITTI's layout
# ---------------------------------------------------------------------------

# the calibration of KITTI's raw drives of 2011-09-26 (P0..P3, R0_rect,
# Tr_velo_to_cam, Tr_imu_to_velo), as the dataset's calib files hold it
KITTI_CALIB = """P0: 7.215377e+02 0 6.095593e+02 0 0 7.215377e+02 1.728540e+02 0 0 0 1 0
P1: 7.215377e+02 0 6.095593e+02 -3.875744e+02 0 7.215377e+02 1.728540e+02 0 0 0 1 0
P2: 7.215377e+02 0 6.095593e+02 4.485728e+01 0 7.215377e+02 1.728540e+02 2.163791e-01 0 0 1 2.745884e-03
P3: 7.215377e+02 0 6.095593e+02 -3.395242e+02 0 7.215377e+02 1.728540e+02 2.199936e+00 0 0 1 2.729905e-03
R0_rect: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01
Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 -4.069766e-03 1.480249e-02 7.280733e-04 -9.998902e-01 -7.631618e-02 9.998621e-01 7.523790e-03 1.480755e-02 -2.717806e-01
Tr_imu_to_velo: 9.999976e-01 7.553071e-04 -2.035826e-03 -8.086759e-01 -7.854027e-04 9.998898e-01 -1.482298e-02 3.195559e-01 2.024406e-03 1.482454e-02 9.998881e-01 -7.997231e-01
"""
GROUND_Z = -1.73            # lidar height above the road
IMAGE_SHAPE = (375, 1242)
FOV_HALF_ANGLE = np.radians(35.0)


def _place_objects(rng, names, x_range, y_half):
    """Non-overlapping boxes of the classes `names` (KITTI_SIZES; lidar
    frame, bottoms on the ground) inside the camera's field of view: a Car
    5.5 m from every earlier centre, a Pedestrian or Cyclist 3 m.
    Pedestrians and Cyclists stay within 40 m, where their image boxes are
    at least KITTI's 25 pixels high (difficulty moderate or easy)."""
    boxes = []
    for name in names:
        far = x_range[1] if name == 'Car' else min(x_range[1], 40.0)
        gap = 5.5 if name == 'Car' else 3.0       # centre to centre, m
        while True:
            x = rng.uniform(x_range[0], far)
            y_max = min(y_half, x * np.tan(FOV_HALF_ANGLE) - 1.5)
            if y_max <= 0:
                continue
            y = rng.uniform(-y_max, y_max)
            if any(np.hypot(x - b[0], y - b[1]) < gap for b in boxes):
                continue
            break
        l, w, h = (rng.uniform(*r) for r in KITTI_SIZES[name])
        boxes.append([x, y, GROUND_Z + h / 2, l, w, h,
                      rng.uniform(-np.pi, np.pi)])
    return np.array(boxes, np.float32).reshape(-1, 7)


def _frame_points(rng, boxes, names, n_points, ground_radius):
    """n_points over 360 degrees: points inside each box
    (KITTI_OBJECT_POINTS of its class), then ground and clutter out to
    ground_radius."""
    parts = []
    for b, name in zip(boxes, names):
        k = rng.randint(*KITTI_OBJECT_POINTS[name])
        local = rng.uniform(-0.5, 0.5, (k, 3)) * b[3:6]
        xyz = common.rotate_points_along_z_np(local, np.array([b[6]]))
        parts.append(np.concatenate([xyz + b[:3],
                                     rng.uniform(0, 1, (k, 1))], 1))
    n_rest = max(n_points - sum(len(p) for p in parts), 0)
    theta = rng.uniform(-np.pi, np.pi, n_rest)
    r = np.sqrt(rng.uniform(4.0, ground_radius ** 2, n_rest))
    z = np.where(rng.uniform(0, 1, n_rest) < 0.8,
                 GROUND_Z + rng.normal(0, 0.03, n_rest),
                 rng.uniform(GROUND_Z, 1.0, n_rest))
    parts.append(np.stack([r * np.cos(theta), r * np.sin(theta), z,
                           rng.uniform(0, 1, n_rest)], 1))
    return np.concatenate(parts).astype(np.float32)


DEPTH_SCALE = 256.0         # depth_2 PNGs hold metres x 256
RENDER_DEPTH_MAX = 46.8     # CaDDN's depth_max: the image's depth channel


def _kitti_calibration():
    lines = KITTI_CALIB.splitlines()

    def row(i, shape):
        return np.array(lines[i].split(' ')[1:], np.float32).reshape(shape)
    return calibration_kitti.Calibration(
        {'P2': row(2, (3, 4)), 'P3': row(3, (3, 4)), 'R0': row(4, (3, 3)),
         'Tr_velo2cam': row(5, (3, 4))})


def render_camera(points, calib, image_shape=IMAGE_SHAPE):
    """Lidar points seen by the left colour camera -> (image (H, W, 3)
    uint8, depth map (H, W) uint16 of metres x 256, 0 where no point
    projects).  Each pixel shows its nearest point: the image's channels
    are its depth over RENDER_DEPTH_MAX, 255 (a return) and its height
    (-3..1 m), the depth map its depth, as KITTI's depth_2 maps are
    projected lidar."""
    h, w = image_shape
    pts_img, depth = calib.rect_to_img(calib.lidar_to_rect(points[:, :3]))
    u = np.floor(pts_img[:, 0]).astype(np.int64)
    v = np.floor(pts_img[:, 1]).astype(np.int64)
    ok = (depth > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    pix, d, z = v[ok] * w + u[ok], depth[ok], points[ok, 2]
    order = np.lexsort((d, pix))            # per pixel, nearest first
    pix, d, z = pix[order], d[order], z[order]
    first = np.r_[True, pix[1:] != pix[:-1]]
    pix, d, z = pix[first], d[first], z[first]
    image = np.zeros((h * w, 3), np.float32)
    image[pix, 0] = np.clip(d / RENDER_DEPTH_MAX, 0, 1)
    image[pix, 1] = 1.0
    image[pix, 2] = np.clip((z + 3.0) / 4.0, 0, 1)
    depth_map = np.zeros(h * w, np.float64)
    depth_map[pix] = np.minimum(np.round(d * DEPTH_SCALE), 65535)
    return ((image * 255).round().astype(np.uint8).reshape(h, w, 3),
            depth_map.astype(np.uint16).reshape(h, w))


def _frame_names(rng, cars, three_class, first):
    n_car = rng.randint(cars[0], cars[1] + 1)
    names = ['Car'] * n_car
    if three_class:
        for name in ('Pedestrian', 'Cyclist'):
            ratio = KITTI_LABEL_COUNTS[name] / KITTI_LABEL_COUNTS['Car']
            k = int(np.floor(n_car * ratio + rng.uniform()))
            names += [name] * (max(k, 1) if first else k)
    return names


def write_kitti_tree(root, n_train, n_val, seed=0, n_points=120_000,
                     cars=(10, 18), x_range=(6.0, 55.0), y_half=30.0,
                     ground_radius=70.0, three_class=False, camera=False):
    """A synthetic data tree in KITTI's layout under `root` (training/
    {velodyne, label_2, calib, planes}, ImageSets/{train, val}.txt): frames
    of `n_points` lidar points over 360 degrees, between cars[0] and
    cars[1] labelled Car boxes in the camera's view plus one DontCare
    region, KITTI's calibration and a flat road plane.  With three_class,
    each frame also holds Pedestrians and Cyclists at KITTI's ratios to its
    Cars (KITTI_LABEL_COUNTS, rounded stochastically; the first frame at
    least one of each).  With camera, training/image_2 and depth_2 PNGs
    (render_camera, 375 x 1242) too.  Returns `root`."""
    root = Path(root)
    subs = ('velodyne', 'label_2', 'calib', 'planes')
    for sub in subs + (('image_2', 'depth_2') if camera else ()):
        (root / 'training' / sub).mkdir(parents=True, exist_ok=True)
    (root / 'ImageSets').mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = [f'{i:06d}' for i in range(n_train + n_val)]
    for fid in ids:
        calib_file = root / 'training/calib' / f'{fid}.txt'
        calib_file.write_text(KITTI_CALIB)
        calib = calibration_kitti.Calibration(str(calib_file))
        names = _frame_names(rng, cars, three_class, fid == ids[0])
        boxes = _place_objects(rng, names, x_range, y_half)
        pts = _frame_points(rng, boxes, names, n_points, ground_radius)
        cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
        img = box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib,
                                                           IMAGE_SHAPE)
        alpha = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
        lines = [f'{names[i]} 0.00 0 {alpha[i]:.2f} {img[i, 0]:.2f} '
                 f'{img[i, 1]:.2f} '
                 f'{img[i, 2]:.2f} {img[i, 3]:.2f} {cam[i, 4]:.2f} '
                 f'{cam[i, 5]:.2f} {cam[i, 3]:.2f} {cam[i, 0]:.2f} '
                 f'{cam[i, 1]:.2f} {cam[i, 2]:.2f} {cam[i, 6]:.2f}'
                 for i in range(len(boxes))]
        u = rng.uniform(0, IMAGE_SHAPE[1] - 60)
        lines.append(f'DontCare -1 -1 -10 {u:.2f} 170.00 {u + 50:.2f} '
                     f'200.00 -1 -1 -1 -1000 -1000 -1000 -10')
        pts.tofile(str(root / 'training/velodyne' / f'{fid}.bin'))
        if camera:
            image, depth = render_camera(pts, calib)
            png.write_png(root / 'training/image_2' / f'{fid}.png', image)
            png.write_png(root / 'training/depth_2' / f'{fid}.png', depth)
        (root / 'training/label_2' / f'{fid}.txt').write_text(
            '\n'.join(lines) + '\n')
        (root / 'training/planes' / f'{fid}.txt').write_text(
            '# Plane\nWidth 4\nHeight 1\n0 -1 0 1.65\n')
    (root / 'ImageSets/train.txt').write_text('\n'.join(ids[:n_train]) + '\n')
    (root / 'ImageSets/val.txt').write_text('\n'.join(ids[n_train:]) + '\n')
    return root


WAYMO_DB_INFO = 'waymo_processed_data_v0_5_0_waymo_dbinfos_train_sampled_1.pkl'
# (length, width, height) ranges of the crops' boxes, metres
CROP_SIZES = {'Car': ((3.4, 4.6), (1.5, 1.9), (1.4, 1.8)),
              'Van': ((4.5, 5.5), (1.8, 2.1), (1.9, 2.4)),
              'Vehicle': ((4.2, 5.2), (1.8, 2.3), (1.5, 1.9))}
CROPS_PER_FRAME = 4


def write_crop_database(root, n_car, n_van=0, seed=0, waymo=False):
    """A synthetic gt database under `root` in the layout
    create_groundtruth_database writes, for the CVAE's crop datasets:
    gt_database/<frame>_<name>_<i>.bin crops stored relative to their box
    centre, kitti_dbinfos_train.pkl ({name: [{'path', 'image_idx',
    'gt_idx', 'box3d_lidar', 'num_points_in_gt', 'name'}]}), and
    training/{calib, planes}/<frame>.txt per frame of CROPS_PER_FRAME
    objects, which the occlusion augmentation reads.  Boxes sit on the road
    in the camera's view; point counts per crop are log-normal (median 100,
    about 6% above 1000), so dense donors exist.  That distribution is
    assumed, not fitted to KITTI's num_points_in_gt: host costs that depend
    on crop sizes (the occlusion's, the reads') hold only for it.  With
    waymo=True: n_car 'Vehicle' crops of 5 features (intensity, elongation)
    keyed by 'sequence_name' / 'sample_idx', in WAYMO_DB_INFO.  Returns the
    database dict."""
    root = Path(root)
    (root / 'gt_database').mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = ['Vehicle'] * n_car if waymo else ['Car'] * n_car + ['Van'] * n_van
    names = [names[i] for i in rng.permutation(len(names))]
    n_feat = 5 if waymo else 4
    db = {}
    for k, name in enumerate(names):
        frame, gt_idx = divmod(k, CROPS_PER_FRAME)
        if gt_idx == 0 and not waymo:
            for sub, text in (('calib', KITTI_CALIB),
                              ('planes', '# Plane\nWidth 4\nHeight 1\n'
                                         '0 -1 0 1.65\n')):
                path = root / 'training' / sub / f'{frame:06d}.txt'
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(text)
        x = rng.uniform(5.0, 60.0)
        y = rng.uniform(-1, 1) * x * np.tan(FOV_HALF_ANGLE)
        dims = [rng.uniform(*r) for r in CROP_SIZES[name]]
        box = np.array([x, y, GROUND_Z + dims[2] / 2, *dims,
                        rng.uniform(-np.pi, np.pi)], np.float32)
        n = int(np.clip(rng.lognormal(np.log(100.0), 1.5), 1, 20000))
        local = rng.uniform(-0.5, 0.5, (n, 3)) * box[3:6]
        pts = np.concatenate([
            common.rotate_points_along_z_np(local, np.array([box[6]])),
            rng.uniform(0, 1, (n, n_feat - 3))], 1).astype(np.float32)
        fid = f'{frame:06d}'
        rel = f'gt_database/{fid}_{name}_{gt_idx}.bin'
        pts.tofile(str(root / rel))
        info = {'name': name, 'path': rel, 'gt_idx': gt_idx,
                'box3d_lidar': box, 'num_points_in_gt': n}
        if waymo:
            info.update(sequence_name=f'seq_{frame // 8:04d}',
                        sample_idx=frame % 8)
        else:
            info['image_idx'] = fid
        db.setdefault(name, []).append(info)
    with open(root / (WAYMO_DB_INFO if waymo else 'kitti_dbinfos_train.pkl'),
              'wb') as f:
        pickle.dump(db, f)
    return db


def add_label_variances(root, seed=0, car_class='Car'):
    """Write a label variance in [0.01, 0.2) per box coordinate into the
    infos (annos['uncertainty'], -1 for other classes) and the gt database
    entries of `root` of `car_class` (a name, or a tuple of names), in the
    form the CVAE's uncertainty injection gives them, so the KL loss sees
    positive variances."""
    classes = (car_class,) if isinstance(car_class, str) else car_class
    root = Path(root)
    rng = np.random.RandomState(seed)
    variances = {}
    for name in ('kitti_infos_train.pkl', 'kitti_infos_val.pkl'):
        with open(root / name, 'rb') as f:
            infos = pickle.load(f)
        for info in infos:
            annos = info['annos']
            unc = np.full((len(annos['name']), 7), -1.0)
            for i, n in enumerate(annos['name']):
                if n in classes:
                    unc[i] = rng.uniform(0.01, 0.2, 7)
                    variances[(info['image']['image_idx'], i)] = unc[i]
            annos['uncertainty'] = unc
        with open(root / name, 'wb') as f:
            pickle.dump(infos, f)
    with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
        db_infos = pickle.load(f)
    for name in classes:
        for info in db_infos.get(name, []):
            info['uncertainty'] = variances[(info['image_idx'],
                                             info['gt_idx'])]
    with open(root / 'kitti_dbinfos_train.pkl', 'wb') as f:
        pickle.dump(db_infos, f)


# ---------------------------------------------------------------------------
# synthetic Waymo scenes and a data tree in Waymo's processed layout
# ---------------------------------------------------------------------------

WAYMO_RANGE = 75.2          # metres, the x / y half extent of the grid
WAYMO_N_POINTS = 170_000    # points per frame of the 64-beam top lidar and
                            # the 4 short-range lidars, both returns
WAYMO_MAX_GT = 256          # MAX_GT_PER_SCENE of waymo_dataset.yaml
VEHICLE_SIZE = ((4.2, 5.2), (1.8, 2.3), (1.5, 1.9))   # l, w, h ranges
# Vehicles per frame, drawn uniformly from this range: its mean, 26.5, is
# the Waymo Open Dataset's (about 6.1 M 3D Vehicle labels over 1150 scenes
# of 20 s at 10 Hz, Sun et al., CVPR 2020); the spread is assumed (the
# paper gives no per-frame distribution) and puts about a quarter of the
# frames under the 15 Vehicles that waymo_dataset.yaml's gt sampling fills
# a scene up to.
WAYMO_VEHICLES = (1, 52)


def _place_vehicles(rng, n):
    """n non-overlapping Vehicle boxes over 360 degrees, 4-70 m away, on
    the ground (z = 0 in Waymo's vehicle frame)."""
    boxes = []
    while len(boxes) < n:
        r, t = rng.uniform(4.0, 70.0), rng.uniform(-np.pi, np.pi)
        x, y = r * np.cos(t), r * np.sin(t)
        if any(np.hypot(x - b[0], y - b[1]) < 6.0 for b in boxes):
            continue
        l, w, h = (rng.uniform(*v) for v in VEHICLE_SIZE)
        boxes.append([x, y, h / 2, l, w, h, rng.uniform(-np.pi, np.pi)])
    return np.array(boxes, np.float32).reshape(-1, 7)


def waymo_frame(rng, n_points=WAYMO_N_POINTS, vehicles=WAYMO_VEHICLES):
    """One synthetic Waymo frame: (points (n_points, 6) [x y z intensity
    elongation NLZ] over 360 degrees out to the grid's range, raw intensity
    before tanh, 2% of the points in a no-label zone (flag 1, the rest -1);
    Vehicle boxes (M, 7), M uniform in `vehicles`, with a cluster of points
    in each, fewer the farther they are, in proportion to n_points).  The
    ground's density falls as 1 / range, as a spinning lidar's does."""
    boxes = _place_vehicles(rng, rng.randint(vehicles[0], vehicles[1] + 1))
    parts = []
    for b in boxes:
        k = int(3000 * n_points / WAYMO_N_POINTS
                * np.exp(-np.hypot(b[0], b[1]) / 25.0)) + 30
        local = rng.uniform(-0.5, 0.5, (k, 3)) * b[3:6]
        parts.append(common.rotate_points_along_z_np(
            local, np.array([b[6]])) + b[:3])
    n_rest = max(n_points - sum(len(p) for p in parts), 0)
    r = rng.uniform(3.0, WAYMO_RANGE * np.sqrt(2), n_rest)
    t = rng.uniform(-np.pi, np.pi, n_rest)
    z = np.where(rng.uniform(0, 1, n_rest) < 0.75,
                 rng.normal(0.0, 0.05, n_rest), rng.uniform(0.0, 4.0, n_rest))
    parts.append(np.stack([r * np.cos(t), r * np.sin(t), z], 1))
    xyz = np.concatenate(parts)[:n_points]
    feats = np.stack([rng.exponential(0.3, len(xyz)),
                      rng.uniform(0, 1, len(xyz)),
                      np.where(rng.uniform(0, 1, len(xyz)) < 0.02, 1.0,
                               -1.0)], 1)
    return np.concatenate([xyz, feats], 1).astype(np.float32), boxes


def _model_points(raw, n_points):
    """A frame's raw (N, 6) points as the detector's input: the points out
    of the no-label zone, tanh of the intensity (WaymoDataset.get_lidar),
    the range mask, padded to n_points with a mask."""
    pts = raw[raw[:, 5] == -1][:, :5].copy()
    pts[:, 3] = np.tanh(pts[:, 3])
    keep = (np.abs(pts[:, :2]) <= WAYMO_RANGE).all(1) & (pts[:, 2] >= -2) \
        & (pts[:, 2] <= 4)
    pts = pts[keep][:n_points]
    out = np.zeros((n_points, 5), np.float32)
    out[:len(pts)] = pts
    mask = np.zeros(n_points, bool)
    mask[:len(pts)] = True
    return out, mask


def waymo_scene_batches(n, seed=0, batch=2, device='cuda',
                        n_points=WAYMO_N_POINTS, train=False):
    """`n` batches of `batch` synthetic Waymo scenes (waymo_frame) from one
    RandomState(seed) as the detector takes them: points (B, n_points, 5),
    points_mask; with train=True also the Vehicle gt boxes (class 1) in
    WAYMO_MAX_GT slots, gt_mask and label variances in [0.01, 0.2)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pts = np.zeros((batch, n_points, 5), np.float32)
        pmask = np.zeros((batch, n_points), bool)
        gt = np.zeros((batch, WAYMO_MAX_GT, 8), np.float32)
        gt_mask = np.zeros((batch, WAYMO_MAX_GT), bool)
        unc = np.ones((batch, WAYMO_MAX_GT, 7), np.float32)
        for b in range(batch):
            raw, boxes = waymo_frame(rng, n_points)
            pts[b], pmask[b] = _model_points(raw, n_points)
            k = min(len(boxes), WAYMO_MAX_GT)
            gt[b, :k, :7], gt[b, :k, 7] = boxes[:k], 1
            gt_mask[b, :k] = True
            unc[b, :k] = rng.uniform(0.01, 0.2, (k, 7))
        fields = [('points', pts), ('points_mask', pmask)]
        if train:
            fields += [('gt_boxes', gt), ('gt_mask', gt_mask),
                       ('gt_uncertainty', unc)]
        out.append({k: torch.from_numpy(v).to(device) for k, v in fields})
    return out


WAYMO_PROCESSED = 'waymo_processed_data_v0_5_0'


def write_waymo_tree(root, n_seq, frames_per_seq, seed=0,
                     n_points=WAYMO_N_POINTS, vehicles=WAYMO_VEHICLES,
                     n_val_seq=1):
    """A synthetic data tree in the layout of
    waymo_raw.process_single_sequence under `root`:
    WAYMO_PROCESSED/<seq>/<seq>.pkl and %04d.npy frames of waymo_frame's
    (n_points, 6) points, ImageSets/{train, val}.txt (the last n_val_seq
    sequences are val, the rest train).  Each info holds point_cloud,
    frame_id, metadata, pose, num_points_of_each_lidar and annos: name
    (Vehicle, and one Pedestrian box with no points that the class
    filter drops), gt_boxes_lidar, dimensions, location, heading_angles,
    num_points_in_gt, difficulty (0, or 2 for 5 points or fewer) and the
    label variances `uncertainty` in [0.01, 0.2) (-1 for the Pedestrian),
    so the KL loss sees positive variances.  Returns `root`."""
    root = Path(root)
    (root / 'ImageSets').mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    seqs = [f'segment-{s:05d}_with_camera_labels' for s in range(n_seq)]
    for seq in seqs:
        seq_dir = root / WAYMO_PROCESSED / seq
        seq_dir.mkdir(parents=True, exist_ok=True)
        infos = []
        for f in range(frames_per_seq):
            pts, boxes = waymo_frame(rng, n_points, vehicles)
            np.save(str(seq_dir / f'{f:04d}.npy'), pts)
            ped = np.array([[rng.uniform(-60, 60), rng.uniform(-60, 60),
                             0.9, 0.8, 0.8, 1.8, 0.0]], np.float32)
            all_boxes = np.concatenate([boxes, ped])
            n_in = box_utils.points_in_boxes_np(pts[:, :3],
                                                all_boxes).sum(0)
            unc = np.concatenate([rng.uniform(0.01, 0.2, (len(boxes), 7)),
                                  -np.ones((1, 7))])
            infos.append({
                'point_cloud': {'num_features': 5, 'lidar_sequence': seq,
                                'sample_idx': f},
                'frame_id': f'{seq}_{f:03d}',
                'metadata': {'context_name': seq,
                             'timestamp_micros': 1_500_000_000_000_000
                             + 100_000 * f},
                'pose': np.eye(4, dtype=np.float32),
                'num_points_of_each_lidar': [len(pts), 0, 0, 0, 0],
                'annos': {
                    'name': np.array(['Vehicle'] * len(boxes)
                                     + ['Pedestrian']),
                    'gt_boxes_lidar': all_boxes,
                    'dimensions': all_boxes[:, 3:6],
                    'location': all_boxes[:, :3],
                    'heading_angles': all_boxes[:, 6],
                    'num_points_in_gt': n_in.astype(np.int64),
                    'difficulty': np.where(n_in <= 5, 2, 0).astype(np.int32),
                    'uncertainty': unc,
                }})
        with open(seq_dir / f'{seq}.pkl', 'wb') as fh:
            pickle.dump(infos, fh)
    names = [s + '.tfrecord' for s in seqs]
    split = max(len(names) - n_val_seq, 1)
    (root / 'ImageSets/train.txt').write_text('\n'.join(names[:split]) + '\n')
    (root / 'ImageSets/val.txt').write_text(
        '\n'.join(names[split:] or names[-1:]) + '\n')
    return root


def add_waymo_db_variances(root, split='train'):
    """Copy each gt box's label variances from the infos of `root` into the
    entries of its pcdet_waymo_dbinfos_<split>.pkl (matched by frame and
    gt index), as the CVAE's injection writes them, so sampled boxes carry
    positive variances too.  Returns the number of entries."""
    root = Path(root)
    unc = {}
    for pkl in (root / WAYMO_PROCESSED).glob('*/*.pkl'):
        with open(pkl, 'rb') as f:
            for info in pickle.load(f):
                for i, u in enumerate(info['annos']['uncertainty']):
                    unc[(info['frame_id'], i)] = u
    path = root / f'pcdet_waymo_dbinfos_{split}.pkl'
    with open(path, 'rb') as f:
        db = pickle.load(f)
    n = 0
    for entries in db.values():
        for e in entries:
            e['uncertainty'] = unc[(e['image_idx'], e['gt_idx'])]
            n += 1
    with open(path, 'wb') as f:
        pickle.dump(db, f)
    return n


CAMERA_FRAME_POINTS = 120_000     # lidar points rendered into each frame
DEPTH_DS = 4                      # downsample_depth_map's factor


def camera_batches(n, seed=0, batch=2, device='cuda', image_pad_to=(376, 1248),
                   three_class=True):
    """`n` KITTI-like camera batches of `batch` frames (CaDDN's input at
    full width): each frame's objects (10-18 Cars, with three_class
    Pedestrians and Cyclists at KITTI's ratios; _place_objects within
    46 m) and lidar points rendered through KITTI's calibration
    (render_camera), the image zero-padded to `image_pad_to` in [0, 1]
    with image_shape 375 x 1242, the depth map padded likewise in metres
    and block-mean downsampled by DEPTH_DS, the calibration as
    trans_lidar_to_cam / trans_cam_to_img, the 2-D boxes at the feature
    map's scale (1 / DEPTH_DS), gt boxes with labels, masks and label
    variances in [0.01, 0.2).  `points` is a (B, 1, 4) placeholder."""
    from ..datasets.kitti_dataset import calib_to_matricies
    rng = np.random.RandomState(seed)
    calib = _kitti_calibration()
    l2c, c2i = calib_to_matricies(calib)
    ph, pw = image_pad_to
    h, w = IMAGE_SHAPE
    out = []
    for _ in range(n):
        imgs = np.zeros((batch, ph, pw, 3), np.float32)
        depths = np.zeros((batch, ph // DEPTH_DS, pw // DEPTH_DS), np.float32)
        gt = np.zeros((batch, MAX_GT_PER_SCENE, 8), np.float32)
        gt_mask = np.zeros((batch, MAX_GT_PER_SCENE), bool)
        unc = np.ones((batch, MAX_GT_PER_SCENE, 7), np.float32)
        b2d = np.zeros((batch, MAX_GT_PER_SCENE, 4), np.float32)
        names_all = list(KITTI_LABEL_COUNTS) if three_class else ['Car']
        for b in range(batch):
            names = _frame_names(rng, (10, 18), three_class, b == 0)
            boxes = _place_objects(rng, names, (6.0, 46.0), 30.0)
            pts = _frame_points(rng, boxes, names, CAMERA_FRAME_POINTS, 70.0)
            image, depth = render_camera(pts, calib)
            imgs[b, :h, :w] = image / 255.0
            dm = np.zeros((ph, pw), np.float32)
            dm[:h, :w] = depth / DEPTH_SCALE
            depths[b] = dm.reshape(ph // DEPTH_DS, DEPTH_DS, pw // DEPTH_DS,
                                   DEPTH_DS).mean(axis=(1, 3))
            cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
            k = min(len(boxes), MAX_GT_PER_SCENE)
            gt[b, :k, :7] = boxes[:k]
            gt[b, :k, 7] = [names_all.index(nm) + 1 for nm in names[:k]]
            gt_mask[b, :k] = True
            unc[b, :k] = rng.uniform(0.01, 0.2, (k, 7))
            b2d[b, :k] = box_utils.boxes3d_kitti_camera_to_imageboxes(
                cam, calib, IMAGE_SHAPE)[:k] / DEPTH_DS
        out.append({k: torch.from_numpy(v).to(device) for k, v in (
            ('points', np.zeros((batch, 1, 4), np.float32)),
            ('points_mask', np.zeros((batch, 1), bool)),
            ('images', imgs), ('depth_maps', depths),
            ('trans_lidar_to_cam', np.tile(l2c, (batch, 1, 1))),
            ('trans_cam_to_img', np.tile(c2i, (batch, 1, 1))),
            ('image_shape', np.tile(np.array(IMAGE_SHAPE, np.int32),
                                    (batch, 1))),
            ('gt_boxes', gt), ('gt_mask', gt_mask), ('gt_uncertainty', unc),
            ('gt_boxes2d', b2d), ('gt_boxes2d_mask', gt_mask))})
    return out


def batches_for(cfg, n, seed=0, batch=2, train=False, device='cuda'):
    """`n` synthetic batches for `cfg`'s dataset: camera batches
    (camera_batches) for CaDDN, Waymo scenes
    (waymo_scene_batches) for a WaymoDataset config, nuScenes, Lyft or
    Pandaset scenes (lidar_scene_batches) for theirs, else KITTI-like
    scenes (scene_batches; with train=True three_class_train_batches for
    KITTI's Car, Pedestrian and Cyclist, else train_batches) of N_POINTS
    points, or of the sample_points step's NUM_POINTS where the config
    has one (PointRCNN: 16384)."""
    if cfg.MODEL.get('NAME') == 'CaDDN':
        return camera_batches(
            n, seed, batch, device,
            tuple(cfg.DATA_CONFIG.get('IMAGE_PAD_TO', (376, 1248))),
            three_class=len(cfg.CLASS_NAMES) > 1)
    if cfg.DATA_CONFIG.get('DATASET') == 'WaymoDataset':
        return waymo_scene_batches(n, seed, batch, device, train=train)
    if cfg.DATA_CONFIG.get('DATASET') in ('NuScenesDataset', 'LyftDataset',
                                          'PandasetDataset'):
        return lidar_scene_batches(cfg, n, seed, batch, device, train=train)
    n_points = N_POINTS
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            n_points = int(proc.NUM_POINTS['train' if train else 'test'])
    if train and list(cfg.CLASS_NAMES) == list(KITTI_LABEL_COUNTS):
        return three_class_train_batches(n, seed, batch, device, n_points)
    if train:
        return train_batches(n, seed, batch, device, n_points)
    return scene_batches(n, seed, batch, device, n_points)


# ---------------------------------------------------------------------------
# synthetic nuScenes, Lyft and Pandaset trees in the info-pickle layouts that
# datasets/{nuscenes,lyft,pandaset}_dataset.py read, and their scenes as
# the detector takes them
# ---------------------------------------------------------------------------

# the 10 nuScenes detection classes with OpenPCDet's nuScenes anchor sizes
# (dx, dy, dz), and each one's share of the boxes of a frame.  The shares
# are assumed, not taken from a cited count: cars most common, then
# pedestrians and barriers.
NUSC_CLASSES = dict(zip(NUSCENES_CLASSES, [
    ((4.63, 1.97, 1.74), 0.34), ((6.93, 2.51, 2.84), 0.06),
    ((6.37, 2.85, 3.19), 0.02), ((10.5, 2.94, 3.47), 0.02),
    ((12.29, 2.90, 3.87), 0.03), ((0.50, 2.53, 0.98), 0.15),
    ((2.11, 0.77, 1.47), 0.02), ((1.70, 0.60, 1.28), 0.02),
    ((0.73, 0.67, 1.77), 0.24), ((0.41, 0.41, 1.07), 0.10)]))
# Lyft's 9 classes: mean sizes of each kind and a mix led by cars, both
# assumed, not taken from a cited table
LYFT_CLASSES = {
    'car': ((4.75, 1.92, 1.71), 0.60),
    'pedestrian': ((0.81, 0.77, 1.78), 0.15),
    'motorcycle': ((2.35, 0.96, 1.59), 0.02),
    'bicycle': ((1.76, 0.63, 1.44), 0.06),
    'other_vehicle': ((8.20, 2.79, 3.23), 0.08),
    'bus': ((12.34, 2.96, 3.44), 0.03),
    'truck': ((10.24, 2.84, 3.44), 0.04),
    'emergency_vehicle': ((6.52, 2.45, 2.39), 0.01),
    'animal': ((0.73, 0.36, 0.51), 0.01)}
# nuScenes' lidar (Caesar et al., "nuScenes", CVPR 2020): a 32-beam
# Velodyne HDL-32E sweeping at 20 Hz, about 34 000 points a sweep
NUSC_SWEEP_POINTS = 34_000
NUSC_SWEEP_DT = 0.05
# boxes per frame: the nuScenes paper's 1.4M boxes over 40k key frames
# make a mean of 35; the spread around it is assumed
NUSC_BOXES = (10, 60)
# Lyft's roof lidar (Kesten et al., "Lyft Level 5 AV Dataset 2019", its
# sensor description): 40 beams at 0.2 degrees of azimuth, 10 Hz, so 40 x
# 1800 points a sweep when every ray returns
LYFT_SWEEP_POINTS = 40 * 1800
LYFT_SWEEP_DT = 0.1
LIDAR_HEIGHT = 1.84          # the sensor above the road, metres
NUSC_DB_INFO = 'nuscenes_dbinfos_10sweeps_withvelo.pkl'
LYFT_DB_INFO = 'lyft_dbinfos_10sweeps.pkl'
PANDASET_DB_INFO = 'pandaset_dbinfos_train.pkl'
PANDASET_POINTS = 170_000    # points per frame of Pandaset's Pandar64
PANDASET_CLASSES = {'Car': ((4.5, 1.9, 1.6), 0.7),
                    'Pedestrian': ((0.8, 0.7, 1.75), 0.2),
                    'Cyclist': ((1.76, 0.6, 1.73), 0.1)}


def _draw_boxes(rng, classes, n, radius, z_ground, velocity=True):
    """n non-overlapping boxes of `classes` (name -> ((dx, dy, dz), share))
    within `radius` (x, y half extents), standing on z_ground: (n, 9)
    [x y z dx dy dz yaw vx vy] (vehicles move at up to 10 m/s, the rest at
    up to 1.5 m/s, along their heading; zero without velocity) and
    their names."""
    names = list(classes)
    share = np.array([classes[c][1] for c in names])
    boxes, out_names = [], []
    while len(boxes) < n:
        c = names[rng.choice(len(names), p=share / share.sum())]
        x, y = rng.uniform(-radius[0], radius[0]), rng.uniform(-radius[1],
                                                               radius[1])
        size = np.asarray(classes[c][0]) * rng.uniform(0.9, 1.1, 3)
        if np.hypot(x, y) < 3.0 or any(
                np.hypot(x - b[0], y - b[1]) < (size[0] + b[3]) / 2 + 0.5
                for b in boxes):
            continue
        yaw = rng.uniform(-np.pi, np.pi)
        speed = rng.uniform(0, 10.0 if size[0] > 3 else 1.5) * velocity
        boxes.append([x, y, z_ground + size[2] / 2, *size, yaw,
                      speed * np.cos(yaw), speed * np.sin(yaw)])
        out_names.append(c)
    return np.array(boxes, np.float64).reshape(-1, 9), np.array(out_names)


def _scene_points(rng, boxes, n_points, radius, z_ground, shift=None):
    """(n_points, 3) points in the key frame: a cluster in each box (fewer
    the farther it is, its xy moved by `shift` (n, 2), the box's motion
    since the sweep), the rest on the ground or up to 4 m above it, its
    density falling as 1 / range out to `radius`."""
    parts = []
    for i, b in enumerate(boxes):
        k = int(0.08 * n_points * np.exp(-np.hypot(b[0], b[1]) / 15.0)
                * min(b[3] * b[4] / 8.0, 1.0)) + 5
        local = rng.uniform(-0.5, 0.5, (k, 3)) * b[3:6]
        p = common.rotate_points_along_z_np(local, np.array([b[6]])) + b[:3]
        if shift is not None:
            p[:, :2] -= shift[i]
        parts.append(p)
    n_rest = max(n_points - sum(len(p) for p in parts), 0)
    r = rng.uniform(1.5, radius, n_rest)
    t = rng.uniform(-np.pi, np.pi, n_rest)
    z = np.where(rng.uniform(0, 1, n_rest) < 0.7,
                 z_ground + rng.normal(0.0, 0.05, n_rest),
                 z_ground + rng.uniform(0.0, 4.0, n_rest))
    parts.append(np.stack([r * np.cos(t), r * np.sin(t), z], 1))
    return np.concatenate(parts)[:n_points]


def _inside(points, box):
    """Mask of the points of (N, 3+) inside one (7+,) box."""
    near = np.hypot(points[:, 0] - box[0], points[:, 1] - box[1]) \
        <= np.hypot(box[3], box[4]) / 2 + 0.1
    out = np.zeros(len(points), bool)
    out[near] = box_utils.points_in_boxes_np(
        points[near, :3], np.asarray(box[None, :7], np.float64))[:, 0]
    return out


def _write_db(root, db_dir, db_file, crops):
    """Write each crop's points (relative to its box centre) under db_dir
    and the dbinfos {name: [entries]} to db_file.  box3d_lidar holds the
    7 box columns: glenet_tpu's gt sampling stacks the sampled boxes with
    the scene's 7-column ones and refuses the reference's 9 (with
    velocity)."""
    (root / db_dir).mkdir(parents=True, exist_ok=True)
    db = {}
    for frame_id, i, name, box, pts in crops:
        path = f'{db_dir}/{frame_id}_{name}_{i}.bin'
        rel = pts.copy()
        rel[:, :3] -= box[:3]
        rel.astype(np.float32).tofile(str(root / path))
        db.setdefault(name, []).append({
            'name': name, 'path': path, 'image_idx': frame_id, 'gt_idx': i,
            'box3d_lidar': np.asarray(box[:7], np.float32),
            'num_points_in_gt': int(len(pts)), 'difficulty': 0})
    with open(root / db_file, 'wb') as f:
        pickle.dump(db, f)
    return db


def write_nuscenes_tree(root, n_train, n_val, seed=0, n_points=None,
                        lyft=False, scale=1.0, boxes=NUSC_BOXES,
                        classes=None):
    """A synthetic tree in the layout of nuscenes_raw.create_nuscenes_info
    (lyft: create_lyft_info) under `root`:

      - samples/LIDAR_TOP/<token>.bin key frames and sweeps/LIDAR_TOP/
        <token>.bin sweeps, (N, 5) float32 [x y z intensity ring] in each
        sweep's own sensor frame (the ego drives along x at 0-12 m/s, so
        a sweep's transform_matrix is a translation and a small yaw);
      - the info pickles (nuscenes_infos_10sweeps_{train,val}.pkl, Lyft:
        lyft_infos_{train,val}.pkl) with lidar_path, token, timestamp,
        ref_from_car, car_from_global, MAX_SWEEPS - 1 sweeps (lidar_path,
        transform_matrix, time_lag NUSC_SWEEP_DT or LYFT_SWEEP_DT apart),
        gt_boxes (M, 9) with
        velocities (zero for Lyft, as create_lyft_info writes them),
        gt_names, num_lidar_pts (key-frame points in the box) and
        num_radar_pts;
      - the gt database of the train frames (NUSC_DB_INFO or LYFT_DB_INFO)
        with each box's points of the key frame and its sweeps, 5 features
        [x y z intensity time_lag] as the reference's multi-sweep
        database.

    Key frames and sweeps of n_points (NUSC_SWEEP_POINTS, Lyft
    LYFT_SWEEP_POINTS) each, the dataset yaml's MAX_SWEEPS (nuScenes 10,
    Lyft 5) per sample, the boxes
    per frame uniform in `boxes` (nuScenes' classes and mean of 35, Lyft's
    classes, or `classes` as NUSC_CLASSES gives them), within 50 m
    (`scale` shrinks distances and the point cloud's radius, for toy
    trees).  Returns `root`."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    classes = classes or (LYFT_CLASSES if lyft else NUSC_CLASSES)
    n_points = n_points or (LYFT_SWEEP_POINTS if lyft else NUSC_SWEEP_POINTS)
    n_sweeps = int(repo_yaml(DATASET_YAMLS['lyft' if lyft
                                           else 'nuscenes'])['MAX_SWEEPS'])
    dt = LYFT_SWEEP_DT if lyft else NUSC_SWEEP_DT
    for d in ('samples/LIDAR_TOP', 'sweeps/LIDAR_TOP'):
        (root / d).mkdir(parents=True, exist_ok=True)
    from ..datasets import nuscenes_raw as nr
    splits = {'train': [], 'val': []}
    crops = []
    for f in range(n_train + n_val):
        split = 'train' if f < n_train else 'val'
        token = f'{split}{f:05d}'
        gt, names = _draw_boxes(rng, classes, rng.randint(boxes[0],
                                                          boxes[1] + 1),
                                (48.0 * scale, 48.0 * scale), -LIDAR_HEIGHT,
                                velocity=not lyft)
        speed, yaw_rate = rng.uniform(0, 12.0), rng.uniform(-0.2, 0.2)
        sweeps, merged = [], []
        for k in range(n_sweeps):
            lag = dt * k
            xyz = _scene_points(rng, gt, n_points, 70.0 * scale,
                                -LIDAR_HEIGHT, shift=gt[:, 7:9] * lag)
            feats = np.stack([rng.uniform(0, 100, len(xyz)),
                              rng.randint(0, 32, len(xyz))], 1)
            # the sweep's pose in the key frame: behind by speed * lag
            tm = nr.transform_matrix(
                [-speed * lag, 0.0, 0.0],
                [np.cos(-yaw_rate * lag / 2), 0, 0,
                 np.sin(-yaw_rate * lag / 2)])
            local = (np.linalg.inv(tm) @ np.hstack(
                [xyz, np.ones((len(xyz), 1))]).T)[:3].T
            pts = np.concatenate([local, feats], 1).astype(np.float32)
            rel = (f'samples/LIDAR_TOP/{token}.bin' if k == 0
                   else f'sweeps/LIDAR_TOP/{token}_{k}.bin')
            pts.tofile(str(root / rel))
            merged.append(np.concatenate(
                [xyz, feats[:, :1], np.full((len(xyz), 1), lag)], 1))
            if k:
                sweeps.append({'lidar_path': rel,
                               'sample_data_token': f'{token}_{k}',
                               'transform_matrix': tm, 'time_lag': lag})
        key = merged[0]
        n_lidar = np.array([_inside(key, b).sum() for b in gt], np.int64)
        pose = np.eye(4)
        info = {'lidar_path': f'samples/LIDAR_TOP/{token}.bin',
                'token': token, 'sweeps': sweeps, 'ref_from_car': pose,
                'car_from_global': pose, 'timestamp': 1.5e9 + 0.5 * f,
                'gt_boxes': gt.astype(np.float32),
                'gt_boxes_velocity': np.concatenate(
                    [gt[:, 7:9], np.zeros((len(gt), 1))], 1).astype(
                    np.float32),
                'gt_names': names,
                'gt_boxes_token': np.array([f'{token}_box{i}'
                                            for i in range(len(gt))]),
                'num_lidar_pts': n_lidar,
                'num_radar_pts': np.zeros(len(gt), np.int64)}
        splits[split].append(info)
        if split == 'train':
            allp = np.concatenate(merged)
            for i, b in enumerate(gt):
                inside = _inside(allp, b)
                crops.append((token, i, names[i], b,
                              allp[inside].astype(np.float32)))
    for split, infos in splits.items():
        name = (f'lyft_infos_{split}.pkl' if lyft
                else f'nuscenes_infos_10sweeps_{split}.pkl')
        with open(root / name, 'wb') as fh:
            pickle.dump(infos, fh)
    _write_db(root, 'gt_database_10sweeps' if lyft
              else 'gt_database_10sweeps_withvelo',
              LYFT_DB_INFO if lyft else NUSC_DB_INFO, crops)
    return root


def write_pandaset_tree(root, n_train, n_val, seed=0,
                        n_points=PANDASET_POINTS, scale=1.0,
                        boxes=(10, 40)):
    """A synthetic tree in the layout pandaset_raw.create_pandaset_infos
    writes with extract_frames: extracted/<seq>/<ii>.npy frames of
    (n_points, 4) float32 [x y z intensity] points in the normative ego
    frame (x forward, y left; the ground 1.8 m below the sensor, the
    cloud out to 90 m, most of it in the 140 x 80 m range), sequences of
    4 frames; pandaset_infos_{train,val}.pkl (sequence, frame_idx,
    lidar_path, gt_boxes (M, 7), gt_names of Car, Pedestrian and Cyclist,
    num_lidar_pts); and PANDASET_DB_INFO with the train boxes' crops of 5
    features, the points padded as PandasetDataset pads them (the yaml's
    4 does not build in glenet_tpu: its gt sampling stacks the crops with
    the padded points).  `scale` shrinks distances, for toy trees.  Returns
    `root`."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    splits = {'train': [], 'val': []}
    crops = []
    for f in range(n_train + n_val):
        split = 'train' if f < n_train else 'val'
        seq, ii = f'{f // 4:03d}', f % 4
        gt, names = _draw_boxes(rng, PANDASET_CLASSES,
                                rng.randint(boxes[0], boxes[1] + 1),
                                (65.0 * scale, 36.0 * scale), -1.8,
                                velocity=False)
        xyz = _scene_points(rng, gt, n_points, 90.0 * scale, -1.8)
        pts = np.concatenate([xyz, rng.uniform(0, 100, (len(xyz), 1))],
                             1).astype(np.float32)
        rel = f'extracted/{seq}/{ii:02d}.npy'
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        np.save(str(root / rel), pts)
        inside = [_inside(pts, b) for b in gt]
        splits[split].append({
            'sequence': seq, 'frame_idx': ii, 'lidar_path': rel,
            'gt_boxes': gt[:, :7].astype(np.float32), 'gt_names': names,
            'num_lidar_pts': np.array([m.sum() for m in inside], np.int64)})
        if split == 'train':
            # 5 features, the zero column PandasetDataset pads the points
            # with: glenet_tpu's gt sampling stacks the crops with the
            # padded points and refuses 4
            pts5 = np.concatenate([pts, np.zeros((len(pts), 1),
                                                 np.float32)], 1)
            crops += [(f'{seq}_{ii:02d}', i, names[i], gt[i, :7],
                       pts5[m]) for i, m in enumerate(inside)]
    for split, infos in splits.items():
        with open(root / f'pandaset_infos_{split}.pkl', 'wb') as fh:
            pickle.dump(infos, fh)
    _write_db(root, 'gt_database_train', PANDASET_DB_INFO, crops)
    return root


def lidar_scene_batches(cfg, n, seed=0, batch=2, device='cuda', train=False):
    """`n` batches of `batch` synthetic scenes for a nuScenes, Lyft or
    Pandaset config as the detector takes them: nuScenes / Lyft the key
    frame and MAX_SWEEPS - 1 sweeps (write_nuscenes_tree's scenes, in the
    key frame, time lag as the fifth feature), Pandaset one frame of
    PANDASET_POINTS; the range mask and MAX_POINTS_PER_SCENE padding of
    the dataset; with train=True the gt boxes of CLASS_NAMES in
    MAX_GT_PER_SCENE slots with their 1-based classes, gt_mask and label
    variances in [0.01, 0.2)."""
    data = cfg.DATA_CONFIG
    kind = data.DATASET
    rng = np.random.RandomState(seed)
    pc = np.asarray(data.POINT_CLOUD_RANGE, np.float32)
    n_max, g_max = int(data.MAX_POINTS_PER_SCENE), int(data.MAX_GT_PER_SCENE)
    n_feat = len(data.POINT_FEATURE_ENCODING['used_feature_list'])
    names = list(cfg.CLASS_NAMES)
    out = []
    for _ in range(n):
        pts = np.zeros((batch, n_max, n_feat), np.float32)
        pmask = np.zeros((batch, n_max), bool)
        gt = np.zeros((batch, g_max, 8), np.float32)
        gt_mask = np.zeros((batch, g_max), bool)
        unc = np.ones((batch, g_max, 7), np.float32)
        for b in range(batch):
            if kind == 'PandasetDataset':
                boxes, bn = _draw_boxes(rng, PANDASET_CLASSES,
                                        rng.randint(10, 41), (65.0, 36.0),
                                        -1.8, velocity=False)
                xyz = _scene_points(rng, boxes, PANDASET_POINTS, 90.0, -1.8)
                cloud = np.concatenate(
                    [xyz, rng.uniform(0, 100, (len(xyz), 1))], 1)
            else:
                lyft = kind == 'LyftDataset'
                boxes, bn = _draw_boxes(
                    rng, LYFT_CLASSES if lyft else NUSC_CLASSES,
                    rng.randint(NUSC_BOXES[0], NUSC_BOXES[1] + 1),
                    (48.0, 48.0), -LIDAR_HEIGHT, velocity=not lyft)
                n_sw = int(data.get('MAX_SWEEPS', 1))
                per = LYFT_SWEEP_POINTS if lyft else NUSC_SWEEP_POINTS
                dt = LYFT_SWEEP_DT if lyft else NUSC_SWEEP_DT
                cloud = np.concatenate([np.concatenate([
                    _scene_points(rng, boxes, per, 70.0, -LIDAR_HEIGHT,
                                  shift=boxes[:, 7:9] * dt * k),
                    rng.uniform(0, 100, (per, 1)),
                    np.full((per, 1), dt * k)], 1)
                    for k in range(n_sw)])
            cloud = cloud[:, :n_feat].astype(np.float32)
            keep = ((cloud[:, :3] >= pc[:3]) & (cloud[:, :3] <= pc[3:])).all(1)
            cloud = cloud[keep]
            cloud = cloud[rng.permutation(len(cloud))][:n_max]
            pts[b, :len(cloud)], pmask[b, :len(cloud)] = cloud, True
            sel = [i for i, c in enumerate(bn) if c in names][:g_max]
            k = len(sel)
            gt[b, :k, :7] = boxes[sel, :7]
            gt[b, :k, 7] = [names.index(bn[i]) + 1 for i in sel]
            gt_mask[b, :k] = True
            unc[b, :k] = rng.uniform(0.01, 0.2, (k, 7))
        fields = [('points', pts), ('points_mask', pmask)]
        if train:
            fields += [('gt_boxes', gt), ('gt_mask', gt_mask),
                       ('gt_uncertainty', unc)]
        out.append({k: torch.from_numpy(v).to(device) for k, v in fields})
    return out
