"""Plain PyTorch reference of GLENet-S on Waymo (SECOND with GLENet's
AnchorHeadKLLabel, the GLENet repo's tools/cfgs/waymo_models/GLENet_S.yaml),
for training: the forward from raw points, the anchor targets, every loss
term, autograd's backward, the global-norm clip and adam_onecycle.

Layer equations (OpenPCDet's SECONDNet, GLENet's head and loss):
  - MeanVFE -> VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone;
  - 1x1 convs: cls (A * classes), box (A * 7), direction bins (A * 2) and
    the log variances of the box codes (A * 7); A = 2 anchors a cell;
  - targets: nearest-BEV IoU of anchors and gts (each box's BEV rectangle
    turned to the nearest axis alignment), positive at >= matched, or the
    best anchor(s) of a gt with a nonzero best IoU (forced), background
    below unmatched, else ignored; a positive's regression target is the
    ResidualCoder code of its best gt, its label variance that gt's
    (a forced anchor that is not positive takes the forcing gt's);
  - losses, each summed over the batch's anchors and divided by the batch
    size: sigmoid focal (alpha 0.25, gamma 2) over positives and
    background, each weighted 1 / the scene's positive count;
    KL-label: exp(-s) * smoothL1_{1/9}(sin-difference residual) +
    exp(t - s) - 0.5 (t - s), s = max(predicted log variance, -50),
    t = log(label variance + 1e-10), over positives weighted as above;
    direction-bin cross entropy over positives (bin of the gt heading
    - 0.78539 over [0, 2 pi)); weights cls 1, loc 2, dir 0.2;
  - adam_onecycle at step k of `total_steps`: clip by global norm 10,
    Adam (b2 0.99, eps 1e-8) with the one-cycle b1, decoupled weight decay
    added to the update, the one-cycle LR.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import common


def anchors(head_cfg, grid, pc_range):
    """(H * W * A, 7) anchors, y-major then x then (size, rotation)."""
    (g,) = head_cfg['ANCHOR_GENERATOR_CONFIG']
    stride = g['feature_map_stride']
    nx, ny = grid[0] // stride, grid[1] // stride
    xs = np.linspace(pc_range[0], pc_range[3], nx)
    ys = np.linspace(pc_range[1], pc_range[4], ny)
    out = []
    for y in ys:
        for x in xs:
            for (l, w, h) in g['anchor_sizes']:
                for r in g['anchor_rotations']:
                    out.append([x, y, g['anchor_bottom_heights'][0] + h / 2,
                                l, w, h, r])
    return (torch.tensor(np.asarray(out, np.float32)), g['matched_threshold'],
            g['unmatched_threshold'], len(g['anchor_sizes'])
            * len(g['anchor_rotations']))


def wrap(a, offset, period):
    return a - torch.floor(a / period + offset) * period


def aligned_bev(boxes):
    """(N, 7) -> (N, 4) [x1, y1, x2, y2] of the nearest axis alignment."""
    near_x = wrap(boxes[:, 6], 0.5, math.pi).abs() < math.pi / 4
    dims = torch.where(near_x[:, None], boxes[:, 3:5], boxes[:, [4, 3]])
    return torch.cat([boxes[:, :2] - dims / 2, boxes[:, :2] + dims / 2], 1)


def iou_aligned(a, b):
    lo = torch.maximum(a[:, None, :2], b[None, :, :2])
    hi = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (hi - lo).clamp_min(0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).prod(-1)
    return inter / (area_a[:, None] + area_b[None] - inter).clamp_min(1e-6)


def encode(gt, anc):
    """ResidualCoder: (.., 7) boxes against anchors -> (.., 7) codes."""
    diag = torch.sqrt(anc[:, 3] ** 2 + anc[:, 4] ** 2)
    g = gt[:, 3:6].clamp_min(1e-5)
    a = anc[:, 3:6].clamp_min(1e-5)
    return torch.stack([(gt[:, 0] - anc[:, 0]) / diag,
                        (gt[:, 1] - anc[:, 1]) / diag,
                        (gt[:, 2] - anc[:, 2]) / a[:, 2],
                        torch.log(g[:, 0] / a[:, 0]),
                        torch.log(g[:, 1] / a[:, 1]),
                        torch.log(g[:, 2] / a[:, 2]),
                        gt[:, 6] - anc[:, 6]], 1)


def targets(anc, gt_boxes, gt_mask, gt_unc, matched, unmatched):
    """One scene's (labels (N,) -1 / 0 / 1, codes (N, 7), label variances
    (N, 7)) for a single class."""
    valid = gt_mask & (gt_boxes[:, 7] == 1)
    iou = iou_aligned(aligned_bev(anc), aligned_bev(gt_boxes[:, :7]))
    iou = torch.where(valid[None], iou, -1.0)
    best, best_gt = iou.max(1)
    gt_best = iou.max(0).values
    forced_by = (iou == gt_best[None]) & (valid & (gt_best > 0))[None]
    forced = forced_by.any(1)
    forcing_gt = forced_by.float().argmax(1)
    pos = best >= matched
    labels = torch.full_like(best_gt, -1)
    labels = torch.where(best < unmatched, 0, labels)
    labels = torch.where(forced | pos, 1, labels)
    codes = torch.where((forced | pos)[:, None],
                        encode(gt_boxes[best_gt, :7], anc), 0.0)
    unc = torch.zeros_like(codes)
    unc = torch.where(forced[:, None], gt_unc[forcing_gt], unc)
    unc = torch.where(pos[:, None], gt_unc[best_gt], unc)
    return labels, codes, unc


def smooth_l1(d, beta=1.0 / 9.0):
    n = d.abs()
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def head_and_loss(cfg, params, feats, batch, anc_info, prec):
    """Anchor head over the BEV features (B, C, H, W) and the loss ->
    (total, {term: value})."""
    anc, matched, unmatched, a = anc_info
    hcfg = cfg['MODEL']['DENSE_HEAD']
    lw = hcfg['LOSS_CONFIG']['LOSS_WEIGHTS']
    b = feats.shape[0]

    def conv(name, c):
        y = F.conv2d(prec.op2d(feats),
                     prec.op2d(params[f'dense_head.{name}.weight']),
                     params[f'dense_head.{name}.bias'])
        return y.permute(0, 2, 3, 1).reshape(b, -1, c)

    cls = conv('conv_cls', 1)[..., 0]
    box = conv('conv_box', 7)
    dirs = conv('conv_dir_cls', 2)
    std = conv('conv_box_std', 7)
    per = [targets(anc, batch['gt_boxes'][i], batch['gt_mask'][i],
                   batch['gt_uncertainty'][i], matched, unmatched)
           for i in range(b)]
    labels = torch.stack([p[0] for p in per])
    codes = torch.stack([p[1] for p in per])
    unc = torch.stack([p[2] for p in per])
    pos = labels > 0
    npos = pos.sum(1, keepdim=True).clamp_min(1).float()
    # focal classification over positives and background
    w_cls = ((labels == 0) | pos).float() / npos
    z = pos.float()
    p = torch.sigmoid(cls)
    pt = z * (1 - p) + (1 - z) * p
    bce = cls.clamp_min(0) - cls * z + torch.log1p(torch.exp(-cls.abs()))
    focal = (z * 0.25 + (1 - z) * 0.75) * pt ** 2 * bce
    loss_cls = (focal * w_cls).sum() / b * lw['cls_weight']
    # KL-label regression
    w_reg = pos.float() / npos
    rp = torch.cat([box[..., :6], torch.sin(box[..., 6:7])
                    * torch.cos(codes[..., 6:7])], -1)
    rt = torch.cat([codes[..., :6], torch.cos(box[..., 6:7])
                    * torch.sin(codes[..., 6:7])], -1)
    cw = torch.tensor(lw['code_weights'], dtype=torch.float32,
                      device=box.device)
    l1 = smooth_l1((rp - rt) * cw) * w_reg[..., None]
    s = std.clamp_min(-50.0)
    t = torch.log(unc + 1e-10)
    w = w_reg[..., None]
    parts = {'loc_loss_src': (torch.exp(-s) * l1).sum(),
             'loc_loss_square': (torch.exp(t - s) * w).sum(),
             'loc_loss_log': (-0.5 * (t - s) * w).sum()}
    parts = {k: v / b * lw['loc_weight'] for k, v in parts.items()}
    loss_loc = sum(parts.values())
    # direction bins
    rot = codes[..., 6] + anc[None, :, 6]
    off = wrap(rot - hcfg['DIR_OFFSET'], 0.0, 2 * math.pi)
    dir_t = torch.floor(off / math.pi).long().clamp(0, 1)
    ce = -F.log_softmax(dirs, -1).gather(-1, dir_t[..., None])[..., 0]
    loss_dir = (ce * w_reg).sum() / b * lw['dir_weight']
    total = loss_cls + loss_loc + loss_dir
    return total, dict(parts, loss_cls=loss_cls, loss_loc=loss_loc,
                       loss_dir=loss_dir)


def one_cycle(first, peak, last, total, pct):
    split = int(total * pct)

    def at(step):
        if step < split:
            frac, a, b = step / max(split, 1), first, peak
        else:
            frac, a, b = (step - split) / max(total - split, 1), peak, last
        frac = min(max(frac, 0.0), 1.0)
        return b + (a - b) / 2.0 * (math.cos(math.pi * frac) + 1.0)
    return at


def forward_loss(cfg, budgets, params, stats, batch, anc_info, prec):
    mcfg = cfg['MODEL']
    vox, v = common.voxelize_batch(batch['points'], batch['points_mask'],
                                   cfg['DATA_CONFIG'], train=True)
    caps = [int(m * v) for m in budgets['level_caps']]
    grid = anc_info[4]
    bev, _ = common.backbone3d(mcfg['BACKBONE_3D']['NAME'], params,
                                      stats, vox, batch['points'].shape[0],
                                      grid, caps, True, prec)
    feats = common.bev_backbone(mcfg['BACKBONE_2D'], params, stats, bev,
                                True, prec)
    return head_and_loss(cfg, params, feats, batch, anc_info[:4], prec)


def train_steps(cfg, budgets, weights, batches, total_steps, prec):
    """len(batches) steps from `weights` (name -> tensor, BN running
    statistics included) -> (losses, the first step's clipped gradients
    {name: tensor}, weights after the steps {name: tensor}, the BN
    running statistics after the first step {name: tensor}, the first
    step's loss terms {name: value})."""
    dev = batches[0]['points'].device
    dcfg = cfg['DATA_CONFIG']
    vox = {p['NAME']: p for p in dcfg['DATA_PROCESSOR']}[
        'transform_points_to_voxels']
    grid = common.grid_size(dcfg['POINT_CLOUD_RANGE'], vox['VOXEL_SIZE'])
    anc, matched, unmatched, a = anchors(cfg['MODEL']['DENSE_HEAD'], grid,
                                         dcfg['POINT_CLOUD_RANGE'])
    anc_info = (anc.to(dev), matched, unmatched, a, grid)
    is_stat = [k for k in weights if k.endswith(('running_mean',
                                                 'running_var'))]
    stats = {k: weights[k].clone() for k in is_stat}
    names = [k for k in weights if k not in stats]
    params = {k: weights[k].clone().requires_grad_(True) for k in names}
    opt = cfg['OPTIMIZATION']
    lr_max, div, pct = opt['LR'], opt['DIV_FACTOR'], opt['PCT_START']
    lr_at = one_cycle(lr_max / div, lr_max, lr_max / div / 1e4, total_steps,
                      pct)
    b1_at = one_cycle(opt['MOMS'][0], opt['MOMS'][1], opt['MOMS'][0],
                      total_steps, pct)
    mu = {k: torch.zeros_like(params[k]) for k in names}
    nu = {k: torch.zeros_like(params[k]) for k in names}
    losses, first_grads, first_stats = [], None, None
    with common.no_tf32():
        for step, batch in enumerate(batches):
            loss, terms = forward_loss(cfg, budgets, params, stats, batch,
                                       anc_info, prec)
            if step == 0:
                first_terms = {k: float(v.detach()) for k, v in
                               terms.items()}
            grads = torch.autograd.grad(loss, [params[k] for k in names],
                                        allow_unused=True)
            grads = [torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(names, grads)]
            losses.append(float(loss.detach()))
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            clip = opt['GRAD_NORM_CLIP']
            if float(norm) >= clip:
                grads = [g / norm * clip for g in grads]
            if first_grads is None:
                first_grads = {k: g.detach().clone()
                               for k, g in zip(names, grads)}
                first_stats = dict(stats)
            lr, b1, t = lr_at(step), b1_at(step), step + 1
            with torch.no_grad():
                for k, g in zip(names, grads):
                    mu[k] = b1 * mu[k] + (1 - b1) * g
                    nu[k] = 0.99 * nu[k] + 0.01 * g * g
                    upd = ((mu[k] / (1 - b1 ** t))
                           / (torch.sqrt(nu[k] / (1 - 0.99 ** t)) + 1e-8)
                           + opt['WEIGHT_DECAY'] * params[k])
                    params[k] -= lr * upd
            del loss, grads, terms
    final = {k: v.detach() for k, v in params.items()}
    final.update(stats)
    return losses, first_grads, final, first_stats, first_terms
