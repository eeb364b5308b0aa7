"""PointNet++ primitives (torch counterpart of glenet_tpu/ops/pointnet2.py):
ball query, farthest point sampling, grouping and three-nn inverse-distance
interpolation, batched over B instead of vmapped.

Every integer output equals the JAX package's by construction, ties
included:
  - ball_query takes the first `nsample` points within the radius in index
    order from a running count of hits (no top-k, whose tie order torch
    leaves open); empty slots repeat the first hit, and an empty ball
    gathers index 0 in every slot, as JAX's f32 keys `1e10 + index` tie in
    groups there and lax.top_k breaks ties toward the lower index;
  - farthest_point_sample and three_nn take torch's argmax / argmin, which
    return the first extreme index, as jnp.argmax and lax.top_k do.
Squared distances sum the three squared coordinate differences in order x,
y, z, the reference's `((a - b) ** 2).sum(-1)`, never through a matmul
(torch.cdist rounds differently and may run in TF32 on the card): a
one-ulp change near a radius or at an FPS near-tie changes an index.
"""
from __future__ import annotations

import torch

_BIG = 1e10
# elements of one (B, M_chunk, N) distance block of ball_query (and of one
# (B, N_chunk, M) block of three_nn): queries are taken in chunks of at most
# this many, which gives the same indices as one block and bounds the
# temporaries (~13 bytes an element)
CHUNK_ELEMENTS = 1 << 27


def square_distance(a, b):
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances."""
    d2 = None
    for k in range(3):
        t = (a[..., :, None, k] - b[..., None, :, k]).square_()
        d2 = t if d2 is None else d2.add_(t)
    return d2


@torch.no_grad()
def _ball_query_block(r2, nsample, xyz, new_xyz, xyz_mask):
    within = square_distance(new_xyz, xyz) < r2               # (B, M, N)
    if xyz_mask is not None:
        within &= xyz_mask[:, None, :]
    hits = within.cumsum(-1, dtype=torch.int32)               # sorted rows
    del within
    count = hits[..., -1]
    b, m = count.shape
    # the position of the (s + 1)-th hit is the first index where the
    # running count reaches s + 1
    rank = torch.arange(1, nsample + 1, dtype=torch.int32,
                        device=xyz.device).expand(b, m, nsample).contiguous()
    idx = torch.searchsorted(hits, rank)
    got = rank <= count[..., None]
    idx = torch.where(got, idx, idx[..., :1])
    empty = count == 0
    return torch.where(empty[..., None], 0, idx), empty


def ball_query(radius: float, nsample: int, xyz, new_xyz, xyz_mask=None):
    """xyz (B, N, 3) source points; new_xyz (B, M, 3) query centres;
    xyz_mask (B, N) validity.  Returns idx (B, M, nsample) int64, the first
    nsample points with squared distance < radius^2 in index order, empty
    slots repeating the first hit and empty balls all 0; and empty (B, M),
    True where no point is within."""
    # the threshold JAX compares against: its jitted ball_query traces the
    # radius as an f32 scalar and squares it in f32
    r2 = float(torch.tensor(radius, dtype=torch.float32) ** 2)
    b, m, n = new_xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
    step = max(1, CHUNK_ELEMENTS // max(1, b * n))
    parts = [_ball_query_block(r2, nsample, xyz, new_xyz[:, s:s + step],
                               xyz_mask)
             for s in range(0, m, step)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))


@torch.no_grad()
def farthest_point_sample(xyz, npoint: int, mask=None):
    """(B, N, 3) -> (B, npoint) int64 indices: start at the first valid
    point, then take the argmax of each point's running minimum squared
    distance to the taken ones (invalid points at -1, ties to the first
    index).  Once every valid point is taken, the picks go on by the same
    rule (so they repeat), as in the JAX package."""
    b, n = xyz.shape[:2]
    valid = (mask if mask is not None
             else torch.ones((b, n), dtype=torch.bool, device=xyz.device))
    coords = [xyz[..., k].contiguous() for k in range(3)]
    d = torch.full((b, n), _BIG, dtype=xyz.dtype, device=xyz.device)
    last = valid.to(torch.uint8).argmax(-1)
    out = [last]
    rows = torch.arange(b, device=xyz.device)
    for _ in range(1, npoint):
        dist = None
        for c in coords:
            t = (c - c[rows, last][:, None]).square_()
            dist = t if dist is None else dist.add_(t)
        torch.minimum(d, dist, out=d)
        last = torch.where(valid, d, -1.0).argmax(-1)
        out.append(last)
    return torch.stack(out, 1)


def group_points(features, idx):
    """features (B, N, C), idx (B, M, S) -> (B, M, S, C), as an
    index_select of the flattened rows (its backward is an index_add)."""
    b, n, c = features.shape
    offs = torch.arange(b, device=idx.device).reshape(
        b, *([1] * (idx.dim() - 1))) * n
    flat = features.reshape(b * n, c).index_select(0, (idx + offs).reshape(-1))
    return flat.reshape(*idx.shape, c)


@torch.no_grad()
def _three_nn_block(unknown, known, known_mask):
    d2 = square_distance(unknown, known)
    if known_mask is not None:
        d2 = torch.where(known_mask[:, None, :], d2, _BIG)
    picks, dists = [], []
    for _ in range(3):
        i = d2.argmin(-1, keepdim=True)
        dists.append(d2.gather(-1, i))
        picks.append(i)
        d2.scatter_(-1, i, float('inf'))
    return torch.cat(dists, -1), torch.cat(picks, -1)


def three_nn(unknown, known, known_mask=None):
    """(B, N, 3) x (B, M, 3) -> (dist (B, N, 3), idx (B, N, 3) int64): the 3
    nearest knowns in ascending distance, ties to the lower index (masked
    knowns at distance^2 1e10).  The unknowns go in chunks of at most
    CHUNK_ELEMENTS // (B * M) (the same indices as one block)."""
    b, n, m = unknown.shape[0], unknown.shape[1], known.shape[1]
    step = max(1, CHUNK_ELEMENTS // max(1, b * m))
    parts = [_three_nn_block(unknown[:, s:s + step], known, known_mask)
             for s in range(0, n, step)]
    d2, idx = (parts[0] if len(parts) == 1 else
               (torch.cat([p[0] for p in parts], 1),
                torch.cat([p[1] for p in parts], 1)))
    return d2.clamp_min(0).sqrt(), idx


def three_interpolate(features, idx, dist):
    """Inverse-distance-weighted interpolation: features (B, M, C), idx and
    dist (B, N, 3) -> (B, N, C)."""
    w = 1.0 / dist.clamp_min(1e-8) ** 2
    w = w / w.sum(-1, keepdim=True)
    return (group_points(features, idx) * w[..., None]).sum(-2)
