"""Model FLOPs of one call, from the layer shapes and the inputs.

  - a 3D convolution (every one of the sparse backbone's, whether the
    program runs it sparse or densified) counts 2 * Cin * Cout per real
    (output, input) pair of active sites, the pairs counted here from the
    same voxels with the reference's own site rules;
  - a 2D convolution or a 1x1 head counts 2 * Cin * Cout * kh * kw per
    output cell (a transposed one per input cell);
  - BN, activations, voxelization, decode and NMS count nothing;
  - a training step counts three forwards (the backward twice one).
"""
from __future__ import annotations

import torch

from .reference import common

def _hits(table, n_rows):
    return int((table < n_rows).sum())


def backbone3d_flops(name, voxels, batch, voxel_grid, caps, in_ch):
    """Forward FLOPs of the 3D backbone over `voxels` (ids, bidx, feats)
    -> (flops, BEV channels, BEV (H, W))."""
    units, widths, c_out, residual = common.BACKBONES[name]
    per_unit = 2 if residual else 1
    lv = common.backbone_levels(voxels, batch, voxel_grid, caps)
    n = [len(v) for v in lv['levels']]
    pairs = [_hits(t[0], n[i]) for i, t in enumerate(lv['subm'])]
    down = [_hits(t[0], n[i]) for i, t in enumerate(lv['strided'])]
    flops = 2 * pairs[0] * in_ch * widths[0]
    c_in = widths[0]
    for li in range(4):
        if li:
            flops += 2 * down[li - 1] * c_in * widths[li]
        flops += 2 * pairs[li] * units[li] * per_unit * widths[li] ** 2
        c_in = widths[li]
    flops += 2 * down[3] * c_in * c_out
    nx, ny, nz = lv['levels'][4].grid
    return flops, nz * c_out, (ny, nx)


def bev_flops(cfg2d, c_in, hw):
    """BaseBEVBackbone forward FLOPs -> (flops, output channels, (H, W))."""
    h, w = hw
    flops, c = 0, c_in
    out_c, out_hw = 0, None
    for i, layers in enumerate(cfg2d['LAYER_NUMS']):
        s = cfg2d['LAYER_STRIDES'][i]
        h, w = (h + 2 - 3) // s + 1, (w + 2 - 3) // s + 1
        f = cfg2d['NUM_FILTERS'][i]
        flops += 2 * c * f * 9 * h * w + layers * 2 * f * f * 9 * h * w
        c = f
        up_s, up_f = cfg2d['UPSAMPLE_STRIDES'][i], cfg2d[
            'NUM_UPSAMPLE_FILTERS'][i]
        flops += 2 * f * up_f * up_s * up_s * h * w
        out_c += up_f
        out_hw = (h * up_s, w * up_s)
    return flops, out_c, out_hw


def head_flops(head_cfg, c_in, hw, num_class):
    h, w = hw
    if head_cfg['NAME'] == 'CenterHead':
        sh = head_cfg.get('SHARED_CONV_CHANNEL', 64)
        outs = (num_class, 2, 1, 3, 2)
        return 2 * 9 * h * w * (c_in * sh + sum(sh * sh + sh * o
                                                for o in outs))
    anchors = sum(len(g['anchor_sizes']) * len(g['anchor_rotations'])
                  for g in head_cfg['ANCHOR_GENERATOR_CONFIG'])
    per_anchor = num_class + 7 + 7 + head_cfg.get('NUM_DIR_BINS', 2)
    return 2 * h * w * c_in * anchors * per_anchor


def call_flops(cfg, budgets, points, points_mask, train):
    """Model FLOPs of one predict or one train step over a batch."""
    dcfg, mcfg = cfg['DATA_CONFIG'], cfg['MODEL']
    vox_cfg = {p['NAME']: p for p in dcfg['DATA_PROCESSOR']}[
        'transform_points_to_voxels']
    grid = common.grid_size(dcfg['POINT_CLOUD_RANGE'], vox_cfg['VOXEL_SIZE'])
    with torch.no_grad():
        voxels, v = common.voxelize_batch(points, points_mask, dcfg, train)
        caps = [int(m * v) for m in budgets['level_caps']]
        f3d, c_bev, hw = backbone3d_flops(
            mcfg['BACKBONE_3D']['NAME'], voxels, points.shape[0], grid, caps,
            points.shape[-1])
    f2d, c_2d, hw2 = bev_flops(mcfg['BACKBONE_2D'], c_bev, tuple(hw))
    fh = head_flops(mcfg['DENSE_HEAD'], c_2d, hw2,
                    len(cfg['CLASS_NAMES'])) * points.shape[0]
    total = f3d + f2d * points.shape[0] + fh
    return 3 * total if train else total
