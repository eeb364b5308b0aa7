"""Synthetic inputs and seeded random weights for runs on the card
(chip_smoke.py, profile_predict.py, profile_train.py) and for the CPU
tests: no trained checkpoint and no KITTI or Waymo data are in the
repository."""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from ..models.detectors import build_detector
from ..models.layers import MaskedBatchNorm
from ..models.spconv_backbone import VARIANTS
from . import box_utils, calibration_kitti, common

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


def scene_batches(n, seed=0, batch=2, device='cuda'):
    """`n` predict requests of `batch` scenes each, drawn in order from one
    RandomState(seed): {'points', 'points_mask'} on `device`."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pts = torch.from_numpy(np.stack([make_scene(rng)
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


def seeded_detector(cfg, device, seed):
    """Detector with weights drawn from `seed`, BN statistics included (so
    BN is not an identity)."""
    torch.manual_seed(seed)
    det = build_detector(cfg, device='cpu')
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in det.net.modules():
            if isinstance(m, MaskedBatchNorm):
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

def _pcdet_backbone(subm_per_block, out_channels):
    """VoxelBackBone8x(Ciassd): (name, cin, cout, kernel (kz, ky, kx)) of
    each spconv layer in the reference's module order; each is followed by
    a BatchNorm1d."""
    layers = [('conv_input.0', 'in', 16, (3, 3, 3)),
              ('conv1.0.0', 16, 16, (3, 3, 3))]
    for lvl, cin, c, n in zip((2, 3, 4), (16, 32, 64), (32, 64, 64),
                              subm_per_block):
        layers.append((f'conv{lvl}.0.0', cin, c, (3, 3, 3)))
        layers += [(f'conv{lvl}.{j}.0', c, c, (3, 3, 3))
                   for j in range(1, n + 1)]
    return layers + [('conv_out.0', 64, out_channels, (3, 1, 1))]


def pcdet_state_dict(cfg, seed=0, num_point_features=None):
    """A state dict of random tensors under the key names and layouts of
    the reference (OpenPCDet / GLENet) for `cfg`, VoxelRCNN or SECONDNet:
    MeanVFE (no parameters), VoxelBackBone8x or VoxelBackBone8xCiassd
    (spconv 2.x weights (O, kz, ky, kx, I); conv{L}.{block}.{0 conv, 1
    BN}), BaseBEVBackbone (blocks.{i} = ZeroPad, Conv, BN, ReLU, then Conv,
    BN, ReLU per layer; deblocks.{i} = ConvTranspose2d (I, O, k, k), BN,
    ReLU) or SSFA (bottom_up_block_0 = ZeroPad then 3 x Conv, BN, ReLU;
    bottom_up_block_1 = 3 x Conv, BN, ReLU, the first of stride 2; trans_0
    / trans_1 / conv_0 / conv_1 / w_0 / w_1 = Conv, BN (ReLU);
    deconv_block_{i} = ConvTranspose2d (256, 128, 3, 3), BN, ReLU; no conv
    biases), the anchor head (1x1 conv_cls / conv_box / conv_dir_cls with
    biases, conv_box_std for AnchorHeadKLLabel and conv_iou for
    AnchorHeadKLLabelIoU), and in VoxelRCNN the roi head:
    roi_grid_pool_layers.{k} NeighborVoxelSAModuleMSG (mlps_in.0 Conv1d +
    BN1d, mlps_pos.0 Conv2d 1x1 + BN2d, mlps_out.0 Conv1d + BN1d), the
    shared_fc_layer / cls_fc_layers / reg_fc_layers stacks of Linear, BN1d,
    ReLU (and Dropout after every Linear but the last when DP_RATIO > 0),
    cls_pred_layer, reg_pred_layer and, for VoxelRCNNKLLabelIoUHead,
    reg_std_layer, reg_std_bn, reg_std_fc1, reg_std_bn1 and reg_std_fc2.
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

    subm, c_out = VARIANTS[mcfg.BACKBONE_3D.NAME]
    for name, cin, cout, k in _pcdet_backbone(subm, c_out):
        cin = num_point_features if cin == 'in' else cin
        weight(f'backbone_3d.{name}.weight', (cout, *k, cin),
               cin * int(np.prod(k)))
        bn(f'backbone_3d.{name.rsplit(".", 1)[0]}.1', cout)

    # the BEV depth after conv_out, as the reference's dense() gives it
    proc = {p.NAME: p for p in cfg.DATA_CONFIG.DATA_PROCESSOR}
    grid = vox_ops.compute_grid_size(
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
        proc['transform_points_to_voxels'].VOXEL_SIZE)
    g = (grid[0], grid[1], grid[2] + 1)
    for k, s, p in ((3, 2, 1), (3, 2, 1), (3, 2, (0, 1, 1)),
                    ((3, 1, 1), (2, 1, 1), 0)):
        g = sparse.out_grid_size(g, k, s, p)
    c_in = g[2] * c_out

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
    n_anchors = sum(len(a['anchor_sizes']) * len(a['anchor_rotations'])
                    * len(a['anchor_bottom_heights'])
                    for a in head.ANCHOR_GENERATOR_CONFIG)
    n_class = len(cfg.CLASS_NAMES)
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

    if 'ROI_HEAD' not in mcfg:
        return _tensors(sd)
    roi = mcfg.ROI_HEAD
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


def _place_cars(rng, n, x_range, y_half):
    """n non-overlapping Car boxes (lidar frame, bottoms on the ground)
    inside the camera's field of view."""
    boxes = []
    while len(boxes) < n:
        x = rng.uniform(*x_range)
        y_max = min(y_half, x * np.tan(FOV_HALF_ANGLE) - 1.5)
        if y_max <= 0:
            continue
        y = rng.uniform(-y_max, y_max)
        if any(np.hypot(x - b[0], y - b[1]) < 5.5 for b in boxes):
            continue
        l, w, h = (rng.uniform(3.4, 4.6), rng.uniform(1.5, 1.9),
                   rng.uniform(1.4, 1.8))
        boxes.append([x, y, GROUND_Z + h / 2, l, w, h,
                      rng.uniform(-np.pi, np.pi)])
    return np.array(boxes, np.float32).reshape(-1, 7)


def _frame_points(rng, boxes, n_points, ground_radius):
    """n_points over 360 degrees: points inside each car, then ground and
    clutter out to ground_radius."""
    parts = []
    for b in boxes:
        k = rng.randint(300, 1500)
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


def write_kitti_tree(root, n_train, n_val, seed=0, n_points=120_000,
                     cars=(10, 18), x_range=(6.0, 55.0), y_half=30.0,
                     ground_radius=70.0):
    """A synthetic data tree in KITTI's layout under `root` (training/
    {velodyne, label_2, calib, planes}, ImageSets/{train, val}.txt): frames
    of `n_points` lidar points over 360 degrees, between cars[0] and
    cars[1] labelled Car boxes in the camera's view plus one DontCare
    region, KITTI's calibration and a flat road plane.  Returns `root`."""
    root = Path(root)
    for sub in ('velodyne', 'label_2', 'calib', 'planes'):
        (root / 'training' / sub).mkdir(parents=True, exist_ok=True)
    (root / 'ImageSets').mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = [f'{i:06d}' for i in range(n_train + n_val)]
    for fid in ids:
        calib_file = root / 'training/calib' / f'{fid}.txt'
        calib_file.write_text(KITTI_CALIB)
        calib = calibration_kitti.Calibration(str(calib_file))
        boxes = _place_cars(rng, rng.randint(cars[0], cars[1] + 1), x_range,
                            y_half)
        pts = _frame_points(rng, boxes, n_points, ground_radius)
        cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
        img = box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib,
                                                           IMAGE_SHAPE)
        alpha = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
        lines = [f'Car 0.00 0 {alpha[i]:.2f} {img[i, 0]:.2f} {img[i, 1]:.2f} '
                 f'{img[i, 2]:.2f} {img[i, 3]:.2f} {cam[i, 4]:.2f} '
                 f'{cam[i, 5]:.2f} {cam[i, 3]:.2f} {cam[i, 0]:.2f} '
                 f'{cam[i, 1]:.2f} {cam[i, 2]:.2f} {cam[i, 6]:.2f}'
                 for i in range(len(boxes))]
        u = rng.uniform(0, IMAGE_SHAPE[1] - 60)
        lines.append(f'DontCare -1 -1 -10 {u:.2f} 170.00 {u + 50:.2f} '
                     f'200.00 -1 -1 -1 -1000 -1000 -1000 -10')
        pts.tofile(str(root / 'training/velodyne' / f'{fid}.bin'))
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
    infos (annos['uncertainty'], -1 for other classes) and the Car entries
    of the gt database of `root`, in the form the CVAE's uncertainty
    injection gives them, so the KL loss sees positive variances."""
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
                if n == car_class:
                    unc[i] = rng.uniform(0.01, 0.2, 7)
                    variances[(info['image']['image_idx'], i)] = unc[i]
            annos['uncertainty'] = unc
        with open(root / name, 'wb') as f:
            pickle.dump(infos, f)
    with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
        db_infos = pickle.load(f)
    for info in db_infos.get(car_class, []):
        info['uncertainty'] = variances[(info['image_idx'], info['gt_idx'])]
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


def batches_for(cfg, n, seed=0, batch=2, train=False, device='cuda'):
    """`n` synthetic batches for `cfg`'s dataset: Waymo scenes
    (waymo_scene_batches) for a WaymoDataset config, else KITTI-like
    scenes (scene_batches, or train_batches with train=True)."""
    if cfg.DATA_CONFIG.get('DATASET') == 'WaymoDataset':
        return waymo_scene_batches(n, seed, batch, device, train=train)
    if train:
        return train_batches(n, seed, batch, device)
    return scene_batches(n, seed, batch, device)
