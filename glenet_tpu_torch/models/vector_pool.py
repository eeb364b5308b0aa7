"""VectorPool aggregation of PV-RCNN++ (torch counterpart of
glenet_tpu/models/vector_pool.py).

  - each query point owns a dense local grid of sub-voxels (e.g. 3 x 3 x 3)
    of half-extent MAX_NEIGHBOR_DISTANCE (`local_grid_offsets`);
  - `local_interpolation`: every sub-voxel centre interpolates the 3
    nearest support points within a cube (or ball) of twice that distance
    by inverse distance, with the 9 offsets to those points
    (`three_nn_within`, `interpolate_into_grids`);
  - `voxel_avg_pool` / `voxel_random_choice`: support points are binned
    into the query's sub-voxels and averaged, or the first one in support
    order taken, with the 3-dim pooled offset (`pool_into_grids`);
  - the features are first reduced to NUM_REDUCED_CHANNELS by summing the
    channels k, k + r, k + 2r, ...; a grouped linear `separate_w` (G, C_in,
    D) mixes each sub-voxel's channels on its own, then BN, ReLU and the
    shared post-MLPs (`VectorPoolAggregation`);
  - the MSG wrapper runs NUM_GROUPS of them and fuses their outputs with
    the absolute query xyz (`VectorPoolAggregationMSG`).

Every function takes the batch on its first axis (JAX vmaps them over it).
Each scene's support points are first compacted to its valid ones (one
host sync per scene and call): a masked point never becomes a neighbour,
and the index glenet_tpu gives an invalid neighbour slot, 0 (the argmin of
a row of equal 1e10s), is kept, so the outputs equal those of a scan of
every slot.  The queries then go in chunks whose (chunk x support) matrix
holds about CHUNK_BYTES, the port's own choice (glenet_tpu caps it at 128
MB; a chunk changes no result).

The neighbour search computes the squared distance as glenet_tpu does,
|q|^2 + |s|^2 - 2 q.s through a matmul (not the sum of squared differences
of ops/pointnet2.py), so the same neighbours and weights come out; on the
card the matmul runs in f32 (TF32 stays off, torch's default).  The
distance work carries no gradient: in the detectors every coordinate that
reaches it (keypoints, voxel centres, RoI grid points) comes from the data
or from detached proposals, so the gradients reach only the features
gathered by index, as in glenet_tpu.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MaskedBatchNorm

BIG = 1e10
# bytes of one (query chunk x support) f32 matrix
CHUNK_BYTES = 1 << 29


def local_grid_offsets(rmax: float, num_voxel, device=None):
    """(G, 3) sub-voxel centre offsets: -R + R/n + i 2R/n per axis, in
    meshgrid(indexing='ij') order (x slowest)."""
    axes = [torch.arange(n, dtype=torch.float32, device=device)
            * (2.0 * rmax / n) + (-rmax + rmax / n) for n in num_voxel]
    gx, gy, gz = torch.meshgrid(*axes, indexing='ij')
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)


def _chunk(n_support: int, bytes_per_pair: int = 4) -> int:
    return max(1, CHUNK_BYTES // (bytes_per_pair * max(n_support, 1)))


def sum_squares(x):
    """(..., 3) -> (...) x0^2 + x1^2 + x2^2 as glenet_tpu's compiled
    reduction rounds it: XLA contracts each `acc + x_k * x_k` into a fused
    multiply-add, so each partial sum is rounded once from the exact
    product (emulated in f64)."""
    acc = x[..., 0] * x[..., 0]
    for k in (1, 2):
        xk = x[..., k].double()
        acc = (xk * xk + acc).float()
    return acc


@torch.no_grad()
def _three_nn_scene(query, support, rmax, neighbor_type):
    """One scene, support already compacted: (dist, idx into support,
    valid), each (Q, 3)."""
    s2 = sum_squares(support)
    dists, idxs = [], []
    for s in range(0, query.shape[0], _chunk(support.shape[0])):
        q = query[s:s + _chunk(support.shape[0])]
        d = (sum_squares(q)[:, None] + s2[None, :]) - (2.0 * q) @ support.T
        d = d.clamp_min_(0.0).sqrt_()
        if neighbor_type == 1:
            ok = d < rmax
        else:
            ok = (q[:, None, 0] - support[None, :, 0]).abs_() < rmax
            for a in (1, 2):
                ok &= (q[:, None, a] - support[None, :, a]).abs_() < rmax
        d.masked_fill_(~ok, BIG)
        del ok
        ds, ii = [], []
        for _ in range(3):
            i = d.argmin(1, keepdim=True)
            ds.append(d.gather(1, i))
            ii.append(i)
            d.scatter_(1, i, BIG)
        dists.append(torch.cat(ds, 1))
        idxs.append(torch.cat(ii, 1))
    dist = torch.cat(dists)
    return dist, torch.cat(idxs), dist < BIG


@torch.no_grad()
def three_nn_within(query, support, support_mask, rmax: float,
                    neighbor_type: int = 0):
    """The 3 nearest valid support points within `rmax` of each query: a
    cube (neighbor_type 0, every |coordinate difference| < rmax) or a ball
    (1, distance < rmax).  query (B, Q, 3); support (B, N, 3);
    support_mask (B, N).  Returns dist (B, Q, 3), idx (B, Q, 3) int64 and
    valid (B, Q, 3), ascending; an invalid slot has dist 1e10 and idx 0."""
    out = []
    for b in range(query.shape[0]):
        keep = support_mask[b].nonzero()[:, 0]
        q = query.shape[1]
        if keep.numel() == 0:
            out.append((query.new_full((q, 3), BIG),
                        torch.zeros((q, 3), dtype=torch.long,
                                    device=query.device),
                        torch.zeros((q, 3), dtype=torch.bool,
                                    device=query.device)))
            continue
        dist, idx, valid = _three_nn_scene(
            query[b], support[b].index_select(0, keep), rmax, neighbor_type)
        out.append((dist, torch.where(valid, keep[idx], 0), valid))
    return tuple(torch.stack(t) for t in zip(*out))


def _gather_rows(x, idx):
    """x (B, N, C), idx (B, ...) -> (B, ..., C) by index_select of the
    flattened rows (its backward is an index_add)."""
    b, n, c = x.shape
    offs = torch.arange(b, device=idx.device).reshape(
        b, *([1] * (idx.dim() - 1))) * n
    return x.reshape(b * n, c).index_select(
        0, (idx + offs).reshape(-1)).reshape(*idx.shape, c)


def interpolate_into_grids(support_xyz, support_feats, support_mask, new_xyz,
                           grid_offsets, rmax: float, neighbor_type: int = 0,
                           distance_multiplier: float = 2.0):
    """`local_interpolation`: each sub-voxel centre (new_xyz + offset)
    takes the inverse-distance mean of its 3 nearest support features
    within rmax * distance_multiplier (weights 1 / (d + 1e-8) over their
    sum clipped at 1e-8; an invalid neighbour weighs ~1e-10), then the 9
    offsets centre - neighbour (invalid slots at support point 0); rows
    whose first neighbour is invalid are zero.  support_xyz (B, N, 3),
    support_feats (B, N, C), support_mask (B, N), new_xyz (B, M, 3),
    grid_offsets (G, 3) -> (B, M, G, C + 9)."""
    b, m = new_xyz.shape[:2]
    g = grid_offsets.shape[0]
    centers = (new_xyz[:, :, None, :] + grid_offsets).reshape(b, m * g, 3)
    dist, idx, valid = three_nn_within(centers, support_xyz, support_mask,
                                       rmax * distance_multiplier,
                                       neighbor_type)
    w = 1.0 / (torch.where(valid, dist, BIG) + 1e-8)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-8)
    interp = (_gather_rows(support_feats, idx) * w[..., None]).sum(2)
    local = (centers[:, :, None, :] - _gather_rows(support_xyz, idx)
             ).reshape(b, m * g, 9)
    out = torch.where(valid[..., :1], torch.cat([interp, local], -1), 0.0)
    return out.reshape(b, m, g, -1)


@torch.no_grad()
def _voxel_keys(q, support, rmax, num_voxel, nsample):
    """rel (c, N, 3) and each pair's sub-voxel id (c, N), G where the point
    lies outside the query's cube or past its first nsample in-cube points
    in support order."""
    rel = support[None, :, :] - q[:, None, :]
    inside = (rel.abs() < rmax).all(-1)
    if nsample > 0:
        inside &= inside.cumsum(1, dtype=torch.int32) <= nsample
    gid = torch.zeros(inside.shape, dtype=torch.int32, device=q.device)
    for a, n in enumerate(num_voxel):
        # the f32 step 2 rmax / n, as glenet_tpu's constant array holds it
        cell = ((rel[..., a] + rmax) / (2.0 * rmax / n)).to(torch.int32)
        gid = gid * n + cell.clamp_(0, n - 1)
    return rel, torch.where(inside, gid, math.prod(num_voxel))


def _pool_scene(support, feats, new_xyz, rmax, num_voxel, avg, nsample):
    """One scene, support compacted -> (M, G, 3 + C)."""
    g = num_voxel[0] * num_voxel[1] * num_voxel[2]
    n, c = feats.shape
    step = _chunk(n, 32)
    outs = []
    for s in range(0, new_xyz.shape[0], step):
        rel, key = _voxel_keys(new_xyz[s:s + step], support, rmax,
                               num_voxel, nsample)
        cq = key.shape[0]
        if avg:
            pf, px, cnt = [], [], []
            for gi in range(g):
                sel = (key == gi).to(feats.dtype)                 # (c, N)
                cnt.append(sel.sum(1, keepdim=True))
                pf.append(sel @ feats / cnt[-1].clamp_min(1.0))
                px.append(torch.einsum('qn,qnd->qd', sel, rel)
                          / cnt[-1].clamp_min(1.0))
            pf, px, cnt = (torch.stack(t, 1) for t in (pf, px, cnt))
            any_ = cnt[..., 0] > 0
        else:
            # the first point of each sub-voxel in support order
            first = torch.full((cq, g + 1), n, dtype=torch.long,
                               device=key.device)
            first.scatter_reduce_(1, key.long(), torch.arange(
                n, device=key.device).expand(cq, n), 'amin')
            first = first[:, :g]
            any_ = first < n
            first = first.clamp_max(n - 1)
            pf = feats.index_select(0, first.reshape(-1)).reshape(cq, g, c)
            px = rel.gather(1, first[..., None].expand(cq, g, 3))
        outs.append(torch.where(any_[..., None],
                                torch.cat([px, pf], -1), 0.0))
    return torch.cat(outs)


def pool_into_grids(support_xyz, support_feats, support_mask, new_xyz,
                    rmax: float, num_voxel, avg: bool, nsample: int = -1):
    """`voxel_avg_pool` (avg) / `voxel_random_choice`: the valid support
    points within each query's cube (|offset| < rmax per axis), with
    nsample > 0 only its first nsample of them in support order, binned into
    its num_voxel sub-voxels (((offset + rmax) / (2 rmax / n)) truncated,
    clipped to the grid); per sub-voxel the pooled offset and features,
    the mean or those of its first point in support order, zero where
    empty.  support_xyz (B, N, 3), support_feats (B, N, C), support_mask
    (B, N), new_xyz (B, M, 3) -> (B, M, G, 3 + C)."""
    num_voxel = tuple(int(v) for v in num_voxel)
    g = num_voxel[0] * num_voxel[1] * num_voxel[2]
    out = []
    for b in range(new_xyz.shape[0]):
        keep = support_mask[b].nonzero()[:, 0]
        if keep.numel() == 0:
            out.append(new_xyz.new_zeros(
                (new_xyz.shape[1], g, 3 + support_feats.shape[-1])))
            continue
        out.append(_pool_scene(support_xyz[b].index_select(0, keep),
                               support_feats[b].index_select(0, keep),
                               new_xyz[b], rmax, num_voxel, avg, nsample))
    return torch.stack(out)


@torch.no_grad()
def sample_points_with_roi_mask(points, points_mask, rois, roi_valid,
                                sample_radius: float):
    """Points whose distance to a valid roi's centre, minus half the roi's
    diagonal, is below `sample_radius`, and valid.  points (B, N, 3),
    points_mask (B, N), rois (B, R, 7+), roi_valid (B, R) -> (B, N)."""
    half_diag = sum_squares(rois[..., 3:6]).sqrt() / 2.0          # (B, R)
    centre = rois[..., :3]
    n = points.shape[1]
    step = _chunk(rois.shape[1] * points.shape[0], 16)
    near = []
    for s in range(0, n, step):
        d = sum_squares(points[:, s:s + step, None, :]
                        - centre[:, None]).sqrt_()
        hit = ((d - half_diag[:, None]) < sample_radius) & roi_valid[:, None]
        near.append(hit.any(-1))
    return torch.cat(near, 1) & points_mask


class VectorPoolAggregation(nn.Module):
    """One VectorPool group (flax `group_<k>`): channel reduction, the local
    interpolation or sub-voxel pooling, `separate_w` (G, C_in, D) per
    sub-voxel, `separate_bn`, ReLU, then `post_<i>` (Linear without bias),
    `post_bn<i>`, ReLU per POST_MLPS entry."""

    def __init__(self, in_channels: int, num_local_voxel,
                 max_neighbor_distance, neighbor_nsample: int = -1,
                 local_aggregation_type: str = 'local_interpolation',
                 num_reduced_channels: int = 30,
                 num_local_agg_channels: int = 32, post_mlps=(128,),
                 neighbor_type: int = 0, distance_multiplier: float = 2.0):
        super().__init__()
        if in_channels % num_reduced_channels:
            raise ValueError(f'input channels {in_channels} not a multiple '
                             f'of {num_reduced_channels}')
        if local_aggregation_type not in ('local_interpolation',
                                          'voxel_avg_pool',
                                          'voxel_random_choice'):
            raise NotImplementedError(
                f'LOCAL_AGGREGATION_TYPE {local_aggregation_type}')
        self.interp = local_aggregation_type == 'local_interpolation'
        if self.interp and neighbor_nsample != -1:
            raise NotImplementedError(
                'NEIGHBOR_NSAMPLE > 0 with local_interpolation')
        self.avg = local_aggregation_type == 'voxel_avg_pool'
        self.num_local_voxel = tuple(int(v) for v in num_local_voxel)
        self.rmax = float(max_neighbor_distance)
        self.nsample = int(neighbor_nsample)
        self.neighbor_type = int(neighbor_type)
        self.distance_multiplier = float(distance_multiplier)
        self.r = int(num_reduced_channels)
        g = math.prod(self.num_local_voxel)
        cin = self.r + (9 if self.interp else 3)
        d = int(num_local_agg_channels)
        self.separate_w = nn.Parameter(torch.empty(g, cin, d))
        # flax's kaiming_normal on (G, C_in, D): fan_in G * C_in, a normal
        # truncated at 2 sigma, rescaled to keep the variance
        std = math.sqrt(2.0 / (g * cin)) / .87962566103423978
        nn.init.trunc_normal_(self.separate_w, std=std, a=-2 * std,
                              b=2 * std)
        self.separate_bn = MaskedBatchNorm(g * d)
        c = g * d
        self.depth = len(post_mlps)
        for i, ch in enumerate(post_mlps):
            setattr(self, f'post_{i}', nn.Linear(c, int(ch), bias=False))
            setattr(self, f'post_bn{i}', MaskedBatchNorm(int(ch)))
            c = int(ch)
        self.out_channels = c

    def forward(self, xyz, xyz_mask, feats, new_xyz, train: bool = False):
        """xyz (B, N, 3), xyz_mask (B, N), feats (B, N, C), new_xyz (B, M,
        3) -> (B, M, out_channels)."""
        b, n, _ = feats.shape
        feats = feats.reshape(b, n, -1, self.r).sum(2)
        if self.interp:
            vec = interpolate_into_grids(
                xyz, feats, xyz_mask, new_xyz,
                local_grid_offsets(self.rmax, self.num_local_voxel,
                                   xyz.device),
                self.rmax, self.neighbor_type, self.distance_multiplier)
        else:
            vec = pool_into_grids(xyz, feats, xyz_mask, new_xyz, self.rmax,
                                  self.num_local_voxel, self.avg,
                                  self.nsample)
        h = torch.einsum('bmgc,gcd->bmgd', vec, self.separate_w)
        h = h.reshape(b, new_xyz.shape[1], -1)
        ra = not train
        h = F.relu(self.separate_bn(h, use_running_average=ra))
        for i in range(self.depth):
            h = F.relu(getattr(self, f'post_bn{i}')(
                getattr(self, f'post_{i}')(h), use_running_average=ra))
        return h


class VectorPoolAggregationMSG(nn.Module):
    """NUM_GROUPS VectorPool groups `group_<k>` on the same queries, their
    outputs concatenated with the absolute query xyz, then `msg_<i>`
    (Linear without bias), `msg_bn<i>`, ReLU per MSG_POST_MLPS entry.
    NUM_REDUCED_CHANNELS defaults to the input channels."""

    def __init__(self, model_cfg, in_channels: int):
        super().__init__()
        self.num_groups = int(model_cfg.NUM_GROUPS)
        c = 0
        for k in range(self.num_groups):
            gcfg = model_cfg[f'GROUP_CFG_{k}']
            grp = VectorPoolAggregation(
                in_channels, gcfg.NUM_LOCAL_VOXEL,
                gcfg.MAX_NEIGHBOR_DISTANCE, int(gcfg.NEIGHBOR_NSAMPLE),
                str(model_cfg.LOCAL_AGGREGATION_TYPE),
                int(model_cfg.get('NUM_REDUCED_CHANNELS') or in_channels),
                int(model_cfg.NUM_CHANNELS_OF_LOCAL_AGGREGATION),
                tuple(gcfg.POST_MLPS))
            setattr(self, f'group_{k}', grp)
            c += grp.out_channels
        c += 3
        mlps = list(model_cfg.get('MSG_POST_MLPS') or ())
        for i, ch in enumerate(mlps):
            setattr(self, f'msg_{i}', nn.Linear(c, int(ch), bias=False))
            setattr(self, f'msg_bn{i}', MaskedBatchNorm(int(ch)))
            c = int(ch)
        self.depth = len(mlps)
        self.out_channels = c

    def forward(self, xyz, xyz_mask, feats, new_xyz, train: bool = False):
        h = torch.cat([getattr(self, f'group_{k}')(xyz, xyz_mask, feats,
                                                   new_xyz, train)
                       for k in range(self.num_groups)] + [new_xyz], -1)
        for i in range(self.depth):
            h = F.relu(getattr(self, f'msg_bn{i}')(
                getattr(self, f'msg_{i}')(h), use_running_average=not train))
        return h
