"""Plain PyTorch reference of CenterPoint on Waymo (OpenPCDet's
tools/cfgs/waymo_models/centerpoint.yaml), for detection: the forward from
raw points, the top-k decode and the final rotated-BEV NMS.

Layer equations (OpenPCDet's CenterPoint):
  - MeanVFE -> VoxelResBackBone8x -> HeightCompression -> BaseBEVBackbone;
  - CenterHead, one head group over the 3 classes: a shared 3x3 conv (with
    bias) -> BN -> ReLU; per map (hm 3, center 2, center_z 1, dim 3, rot 2)
    a 3x3 conv (with bias) -> BN -> ReLU -> 3x3 conv (with bias);
  - decode: sigmoid heatmap, the MAX_OBJ_PER_SAMPLE best (cell, class)
    pairs over the (y, x, class)-flat map (ties to the lower index),
    x = (cell x + center_x) * stride * voxel_x + x_min (y alike),
    z = center_z, dims = exp(dim), heading = atan2(rot_1, rot_0); scores
    under SCORE_THRESH set to 0;
  - NMS (nms_gpu): by score, greedy over rotated BEV IoU > NMS_THRESH, the
    candidates scored above SCORE_THRESH, at most NMS_POST_MAXSIZE kept.
The rotated IoU is polygon clipping (Sutherland-Hodgman) in float64.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import common

MAPS = (('hm', None), ('center', 2), ('center_z', 1), ('dim', 3),
        ('rot', 2))


def center_head(params, stats, x, prec):
    """BEV features (B, C, H, W) -> {map: (B, H, W, c)} (eval mode)."""
    def conv(v, name):
        return F.conv2d(prec.op2d(v), prec.op2d(params[f'{name}.weight']),
                        params[f'{name}.bias'], padding=1)

    def bn(v, name):
        return common.batch_norm(v, params, stats, name, False, cdim=1)

    h = F.relu(bn(conv(x, 'dense_head.Conv_0'),
                  'dense_head.MaskedBatchNorm_0'))
    out = {}
    for name, _ in MAPS:
        y = F.relu(bn(conv(h, f'dense_head.{name}_0'),
                      f'dense_head.{name}_bn0'))
        out[name] = conv(y, f'dense_head.{name}_1').permute(0, 2, 3, 1)
    return out


def decode_all(maps, voxel_size, pc_range, stride):
    """Every cell's box (H * W, 7) and score per class (H * W, C), the
    rot vectors (H * W, 2), scene 0."""
    hm = torch.sigmoid(maps['hm'][0])
    h, w, c = hm.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=hm.device),
                            torch.arange(w, device=hm.device), indexing='ij')
    flat = {k: v[0].reshape(h * w, -1) for k, v in maps.items()}
    x = ((xs.reshape(-1).float() + flat['center'][:, 0]) * stride
         * voxel_size[0] + pc_range[0])
    y = ((ys.reshape(-1).float() + flat['center'][:, 1]) * stride
         * voxel_size[1] + pc_range[1])
    dim = torch.exp(flat['dim'])
    angle = torch.atan2(flat['rot'][:, 1], flat['rot'][:, 0])
    boxes = torch.stack([x, y, flat['center_z'][:, 0], dim[:, 0], dim[:, 1],
                         dim[:, 2], angle], 1)
    return boxes, hm.reshape(h * w, c), flat['rot']


def top_k(boxes, scores, k):
    """The k best (cell, class) pairs of the (cell, class)-flat scores,
    ties to the lower index -> (boxes (k, 7), scores (k,), labels from 1,
    cells (k,))."""
    c = scores.shape[1]
    val, idx = torch.sort(scores.reshape(-1), descending=True, stable=True)
    val, idx = val[:k], idx[:k]
    return boxes[idx // c], val, idx % c + 1, idx // c


def bev_corners(b):
    """(N, 7) float64 numpy -> (N, 4, 2) counter-clockwise corners."""
    hx, hy = b[:, 3] / 2, b[:, 4] / 2
    local = np.stack([np.stack([hx, hy], 1), np.stack([-hx, hy], 1),
                      np.stack([-hx, -hy], 1), np.stack([hx, -hy], 1)], 1)
    c, s = np.cos(b[:, 6])[:, None], np.sin(b[:, 6])[:, None]
    x = local[..., 0] * c - local[..., 1] * s + b[:, None, 0]
    y = local[..., 0] * s + local[..., 1] * c + b[:, None, 1]
    return np.stack([x, y], -1)


def clip_area(p, q):
    """Area of convex polygon p clipped by convex CCW polygon q."""
    poly = list(p)
    for i in range(len(q)):
        a, b = q[i], q[(i + 1) % len(q)]
        edge = b - a
        out = []
        for j in range(len(poly)):
            cur, nxt = poly[j], poly[(j + 1) % len(poly)]
            sc = edge[0] * (cur[1] - a[1]) - edge[1] * (cur[0] - a[0])
            sn = edge[0] * (nxt[1] - a[1]) - edge[1] * (nxt[0] - a[0])
            if sc >= 0:
                out.append(cur)
            if (sc >= 0) != (sn >= 0):
                t = sc / (sc - sn)
                out.append(cur + t * (nxt - cur))
        poly = out
        if not poly:
            return 0.0
    xs = np.array([v[0] for v in poly])
    ys = np.array([v[1] for v in poly])
    return 0.5 * abs(np.dot(xs, np.roll(ys, -1)) - np.dot(ys, np.roll(xs, -1)))


def nms(boxes, scores, thresh, live_thresh, post_max):
    """Greedy NMS over rotated BEV IoU; numpy in, kept indices out (score
    order, ties to the lower index)."""
    b = boxes.astype(np.float64)
    order = np.argsort(-scores, kind='stable')
    corners = bev_corners(b)
    radius = 0.5 * np.hypot(b[:, 3], b[:, 4])
    area = b[:, 3] * b[:, 4]
    kept = []
    for i in order:
        if scores[i] <= live_thresh or len(kept) >= post_max:
            continue
        ok = True
        kk = np.asarray(kept, dtype=np.int64)
        near = kk[np.hypot(b[kk, 0] - b[i, 0], b[kk, 1] - b[i, 1])
                  <= radius[i] + radius[kk]]
        for j in near:
            inter = clip_area(corners[i], corners[j])
            if inter / max(area[i] + area[j] - inter, 1e-6) > thresh:
                ok = False
                break
        if ok:
            kept.append(i)
    return np.array(kept, dtype=np.int64)


def predict(cfg, budgets, weights, points, points_mask, prec):
    """One scene (points (P, C), mask (P,)) -> dict: final boxes (n, 7),
    scores (n,), labels (n,), their ranks among the top-k candidates
    (keep) (numpy), and every cell's decoded box,
    class scores and rot vector (for matching the program's boxes)."""
    dcfg, mcfg = cfg['DATA_CONFIG'], cfg['MODEL']
    post = mcfg['POST_PROCESSING']
    vox_cfg = {p['NAME']: p for p in dcfg['DATA_PROCESSOR']}[
        'transform_points_to_voxels']
    grid = common.grid_size(dcfg['POINT_CLOUD_RANGE'], vox_cfg['VOXEL_SIZE'])
    stride = mcfg['DENSE_HEAD']['TARGET_ASSIGNER_CONFIG'][
        'FEATURE_MAP_STRIDE']
    params = {k: v for k, v in weights.items()}
    with torch.no_grad(), common.no_tf32():
        vox, v = common.voxelize_batch(points[None], points_mask[None], dcfg,
                                       train=False)
        caps = [int(m * v) for m in budgets['level_caps']]
        bev, _ = common.backbone3d(
            mcfg['BACKBONE_3D']['NAME'], params, params, vox, 1, grid, caps,
            False, prec)
        feats = common.bev_backbone(mcfg['BACKBONE_2D'], params, params, bev,
                                    False, prec)
        maps = center_head(params, params, feats, prec)
        boxes, scores, rot = decode_all(maps, vox_cfg['VOXEL_SIZE'],
                                        dcfg['POINT_CLOUD_RANGE'], stride)
        kb, ks, kl, _ = top_k(boxes, scores, int(post['MAX_OBJ_PER_SAMPLE']))
        ks = torch.where(ks >= post['SCORE_THRESH'], ks, 0.0)
    nms_cfg = post['NMS_CONFIG']
    kb_np, ks_np = kb.cpu().numpy(), ks.cpu().numpy()
    keep = nms(kb_np, ks_np, nms_cfg['NMS_THRESH'], post['SCORE_THRESH'],
               int(nms_cfg['NMS_POST_MAXSIZE']))
    return {'boxes': kb_np[keep], 'scores': ks_np[keep],
            'labels': kl.cpu().numpy()[keep], 'keep': keep,
            'all_boxes': boxes, 'all_scores': scores, 'all_rot': rot}
