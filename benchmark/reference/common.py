"""Pieces the references share, in plain PyTorch: voxelization, MeanVFE,
the sparse 3D backbones (VoxelBackBone8x, VoxelResBackBone8x), the BEV map
and BaseBEVBackbone.

A sparse level is a compact list of its active sites over the whole batch:
features (N, C), coordinates (N, 3) as (z, y, x), batch index (N,), and
keys b * cells + linear id, sorted.  A convolution gathers, for each
output site and tap, the input row at o * stride - pad + k (taps in
row-major (z, y, x) order) by a search of the sorted keys, and multiplies
each tap's gathered rows by its (Cin, Cout) slice of the kernel; the
backward gathers too (the transposed convolution through a reverse
table).  Every level is sparse here, the ones the program densifies
too (spconv's rules: a submanifold output keeps its input's sites, a
strided output is active where any active input is under its window);
the BEV map is conv_out's sites scattered into a dense grid.

Budgets, as the configuration states them (`budgets` in its file): at most
MAX_NUMBER_OF_VOXELS voxels, chosen by the first point that falls in each,
MAX_POINTS_PER_VOXEL points in input order; a strided level keeps at most
`level_caps[i] * voxels` sites per scene, dropped by uniform rank
decimation over its sorted ids.

Precision: float32 with TF32 off (`no_tf32`).  `Precision('fp8')` is the
control: the 3D convolutions' operands rounded to float8 e4m3 with one
scale per tensor, the 2D convolutions' to bfloat16, the nearest precisions
below the configuration's (bfloat16 3D-convolution operands, float32
elsewhere); the rounding passes gradients straight through.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.01          # running = (1 - m) * running + m * batch
FP8_MAX = 448.0             # largest finite float8 e4m3 value


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _straight_through(x, rounded):
    return x + (rounded - x).detach()


def round_fp8(x):
    """x rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """Operand rounding of the convolutions: 'f32' or 'fp8' (module
    docstring)."""

    def __init__(self, name: str = 'f32'):
        if name not in ('f32', 'fp8'):
            raise ValueError(f'unknown precision {name}')
        self.name = name

    def op3d(self, x):
        if self.name == 'f32':
            return x
        return _straight_through(x, round_fp8(x.detach()))

    def op2d(self, x):
        if self.name == 'f32':
            return x
        return _straight_through(x, x.detach().to(torch.bfloat16).float())


def grid_size(pc_range, voxel_size):
    return tuple(int(round((pc_range[i + 3] - pc_range[i]) / voxel_size[i]))
                 for i in range(3))


def linear_id(z, y, x, grid):
    nx, ny, _ = grid
    return (z * ny + y) * nx + x


def coords_of(ids, grid):
    nx, ny, _ = grid
    return torch.stack([ids // (ny * nx), (ids // nx) % ny, ids % nx], 1)


# ---------------------------------------------------------------------------
# voxelization and MeanVFE
# ---------------------------------------------------------------------------

def voxelize_mean(points, mask, voxel_size, pc_range, max_voxels,
                  max_points):
    """One scene's voxels: (linear ids (V,) ascending, mean point features
    (V, C)) of at most max_voxels voxels, those whose first point (in input
    order) comes earliest, each averaging its first max_points points."""
    grid = grid_size(pc_range, voxel_size)
    nx, ny, nz = grid
    dev = points.device
    vsize = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    c = torch.floor((points[:, :3] - origin) / vsize).long()
    ok = (mask & (c >= 0).all(1) & (c[:, 0] < nx) & (c[:, 1] < ny)
          & (c[:, 2] < nz))
    idx = torch.nonzero(ok).squeeze(1)                 # ascending
    vid = linear_id(c[idx, 2], c[idx, 1], c[idx, 0], grid)
    uniq, inv = torch.unique(vid, return_inverse=True)
    first = torch.full((uniq.numel(),), idx.numel(), dtype=torch.long,
                       device=dev).scatter_reduce(
        0, inv, torch.arange(idx.numel(), device=dev), 'amin')
    chosen = torch.zeros(uniq.numel(), dtype=torch.bool, device=dev)
    chosen[torch.argsort(first)[:max_voxels]] = True
    slot_of = torch.cumsum(chosen.long(), 0) - 1
    # rank of each point among its voxel's points, in input order
    order = torch.argsort(inv, stable=True)
    inv_s = inv[order]
    start = torch.ones_like(inv_s, dtype=torch.bool)
    start[1:] = inv_s[1:] != inv_s[:-1]
    ar = torch.arange(inv_s.numel(), device=dev)
    rank = ar - torch.cummax(torch.where(start, ar, 0), 0).values
    take = chosen[inv_s] & (rank < max_points)
    rows = slot_of[inv_s[take]]
    n_vox = int(chosen.sum())
    feats = torch.zeros((n_vox, points.shape[1]), dtype=torch.float32,
                        device=dev).index_add_(0, rows,
                                               points[idx[order[take]]])
    count = torch.zeros(n_vox, dtype=torch.float32, device=dev).index_add_(
        0, rows, torch.ones_like(rows, dtype=torch.float32))
    return uniq[chosen], feats / count[:, None]


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

def batch_norm(x, params, stats, name, train, cdim=-1):
    """BatchNorm over channel axis `cdim`: in training the batch moments
    (biased variance) over every other axis, which also move the running
    statistics in `stats`; the running statistics otherwise."""
    cdim = cdim % x.dim()
    shape = [1] * x.dim()
    shape[cdim] = -1
    if train:
        axes = [d for d in range(x.dim()) if d != cdim]
        cnt = x.numel() / x.shape[cdim]
        mean = x.sum(axes) / cnt
        var = ((x * x).sum(axes) / cnt - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            for key, val in (('running_mean', mean), ('running_var', var)):
                stats[f'{name}.{key}'] = ((1 - BN_MOMENTUM)
                                          * stats[f'{name}.{key}']
                                          + BN_MOMENTUM * val.detach())
    else:
        mean = stats[f'{name}.running_mean']
        var = stats[f'{name}.running_var']
    return ((x - mean.reshape(shape)) * torch.rsqrt(var + BN_EPS).reshape(
        shape) * params[f'{name}.weight'].reshape(shape)
        + params[f'{name}.bias'].reshape(shape))


# ---------------------------------------------------------------------------
# sparse levels
# ---------------------------------------------------------------------------

class Level:
    """Active sites of one sparse level over the batch."""

    def __init__(self, ids, bidx, grid):
        nx, ny, nz = grid
        self.grid = grid
        self.cells = nx * ny * nz
        self.ids, self.bidx = ids, bidx
        self.keys = bidx * self.cells + ids                 # ascending
        self.coords = coords_of(ids, grid)

    def __len__(self):
        return self.ids.numel()


def out_grid(grid, kernel, stride, pad):
    """Output (nx, ny, nz) of a convolution; kernel / stride / pad as
    (z, y, x)."""
    return tuple((grid[i] + 2 * pad[2 - i] - kernel[2 - i]) // stride[2 - i]
                 + 1 for i in range(3))


def taps(kernel, device):
    """(K, 3) tap offsets (z, y, x), row-major."""
    axes = [torch.arange(k, device=device) for k in kernel]
    return torch.stack([t.reshape(-1) for t in torch.meshgrid(
        *axes, indexing='ij')], 1)


def gather_table(src: Level, out: Level, kernel, stride, pad):
    """(N_out, K) rows of `src` under each output site's taps (input =
    o * stride - pad + k), len(src) where no active site is."""
    nx, ny, nz = src.grid
    k = taps(kernel, out.ids.device)
    i = out.coords[:, None, :] * torch.tensor(stride, device=k.device) - (
        torch.tensor(pad, device=k.device)) + k[None]
    iz, iy, ix = i.unbind(-1)
    ok = ((iz >= 0) & (iz < nz) & (iy >= 0) & (iy < ny) & (ix >= 0)
          & (ix < nx))
    key = out.bidx[:, None] * src.cells + linear_id(iz, iy, ix, src.grid)
    key = torch.where(ok, key, 0)
    n = len(src)
    pos = torch.searchsorted(src.keys, key)
    hit = ok & (pos < n) & (src.keys[pos.clamp_max(max(n - 1, 0))] == key)
    return torch.where(hit, pos, n)


def reverse_table(src: Level, out: Level, kernel, stride, pad):
    """(N_src, K): for each input site and tap, the output row that reads
    it through that tap (o * stride - pad + k = input), len(out) where
    none does: the gather of the transposed convolution."""
    onx, ony, onz = out.grid
    k = taps(kernel, src.ids.device)
    st = torch.tensor(stride, device=k.device)
    o = src.coords[:, None, :] + torch.tensor(pad, device=k.device) - k[None]
    ok = (o % st == 0).all(-1)
    oz, oy, ox = torch.div(o, st, rounding_mode='floor').unbind(-1)
    ok &= ((oz >= 0) & (oz < onz) & (oy >= 0) & (oy < ony) & (ox >= 0)
           & (ox < onx))
    key = src.bidx[:, None] * out.cells + linear_id(oz, oy, ox, out.grid)
    key = torch.where(ok, key, 0)
    n = len(out)
    pos = torch.searchsorted(out.keys, key)
    hit = ok & (pos < n) & (out.keys[pos.clamp_max(max(n - 1, 0))] == key)
    return torch.where(hit, pos, n)


def _gather_matmul(x, table, w):
    """sum over taps t of x[table[:, t]] @ w[t]; rows past x read 0."""
    padded = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    out = x.new_zeros((table.shape[0], w.shape[-1]))
    for t in range(table.shape[1]):
        out += padded[table[:, t]] @ w[t]
    return out


class _GatherConv(torch.autograd.Function):
    """A convolution as gathers, forward and backward: the input's
    gradient is the transposed convolution, gathered through the reverse
    table, the kernel's the gathered inputs against the output gradient;
    nothing is scattered."""

    @staticmethod
    def forward(ctx, x, w, table, rtable):
        ctx.save_for_backward(x, w, table, rtable)
        return _gather_matmul(x, table, w)

    @staticmethod
    def backward(ctx, g):
        x, w, table, rtable = ctx.saved_tensors
        dx = _gather_matmul(g, rtable, w.transpose(1, 2))
        padded = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        dw = torch.stack([padded[table[:, t]].T @ g
                          for t in range(table.shape[1])])
        return dx, dw, None, None


def sparse_conv(x, tables, kernel, prec):
    """x (N_in, Cin), tables (forward (N_out, K), reverse (N_in, K)),
    kernel (K, Cin, Cout) -> (N_out, Cout)."""
    return _GatherConv.apply(prec.op3d(x), prec.op3d(kernel), *tables)


def decimate(ids, cap):
    """Uniform rank decimation of sorted site ids down to `cap`: keep rank
    r when floor(r * cap / n) advances (float32 arithmetic)."""
    n = ids.numel()
    if cap is None or n <= cap:
        return ids
    dev = ids.device
    ratio = (torch.tensor(float(cap), dtype=torch.float32, device=dev)
             / torch.tensor(float(n), dtype=torch.float32, device=dev))
    r = torch.arange(n, device=dev)
    pos = torch.floor(r.float() * ratio)
    prev = torch.floor((r - 1).float() * ratio)
    return ids[(r == 0) | (pos > prev)]


def strided_sites(src: Level, batch, kernel, stride, pad, cap=None):
    """Active sites of a strided conv over `src` (output o is active where
    some active input sits at o * stride - pad + k), at most `cap` a scene
    (None: no cap) -> Level."""
    grid = out_grid(src.grid, kernel, stride, pad)
    onx, ony, onz = grid
    k = taps(kernel, src.ids.device)
    ids_all, b_all = [], []
    for b in range(batch):
        c = src.coords[src.bidx == b]
        o = c[:, None, :] + torch.tensor(pad, device=k.device) - k[None]
        st = torch.tensor(stride, device=k.device)
        ok = (o % st == 0).all(-1)
        o = torch.div(o, st, rounding_mode='floor')
        oz, oy, ox = o.unbind(-1)
        ok &= ((oz >= 0) & (oz < onz) & (oy >= 0) & (oy < ony) & (ox >= 0)
               & (ox < onx))
        ids = decimate(torch.unique(linear_id(oz, oy, ox, grid)[ok]), cap)
        ids_all.append(ids)
        b_all.append(torch.full_like(ids, b))
    return Level(torch.cat(ids_all), torch.cat(b_all), grid)


def subm_table(level: Level):
    return gather_table(level, level, (3, 3, 3), (1, 1, 1), (1, 1, 1))


def conv_tables(src: Level, out: Level, kernel, stride, pad):
    """(forward, reverse) gather tables of a convolution from src to out."""
    return (gather_table(src, out, kernel, stride, pad),
            reverse_table(src, out, kernel, stride, pad))


def densify(x, level: Level, batch):
    """(N, C) rows of a level -> (B, C, nz, ny, nx) dense."""
    nx, ny, nz = level.grid
    cells = nx * ny * nz
    flat = level.bidx * cells + level.ids
    dense = x.new_zeros((batch * cells, x.shape[1])).index_put(
        (flat,), x)
    return dense.reshape(batch, nz, ny, nx, -1).permute(0, 4, 1, 2, 3)


# ---------------------------------------------------------------------------
# the 3D backbones
# ---------------------------------------------------------------------------

# name -> (subm units per level 1-4, level widths, conv_out width, residual)
BACKBONES = {'VoxelBackBone8x': ((1, 2, 2, 2), (16, 32, 64, 64), 128,
                                 False),
             'VoxelResBackBone8x': ((2, 2, 2, 2), (16, 32, 64, 128), 128,
                                    True)}
# the strided convs: (name, kernel, stride, pad (z, y, x), cap index or
# None) into levels 2, 3, 4 and conv_out
STRIDED = (('conv2_down', (3, 3, 3), (2, 2, 2), (1, 1, 1), 1),
           ('conv3_down', (3, 3, 3), (2, 2, 2), (1, 1, 1), 2),
           ('conv4_down', (3, 3, 3), (2, 2, 2), (0, 1, 1), None),
           ('conv_out', (3, 1, 1), (2, 1, 1), (0, 0, 0), None))


def kernel_of(params, layer):
    """A layer's kernel as (taps, Cin, Cout): a sparse layer's `kernel`
    as it is, a densified one's `weight` (Cout, Cin, kz, ky, kx)
    rearranged."""
    sparse = params.get(f'backbone_3d.{layer}.kernel')
    if sparse is not None:
        return sparse
    w = params[f'backbone_3d.{layer}.weight']
    return w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[1], w.shape[0])


def backbone_levels(voxels, batch, voxel_grid, caps):
    """The sites of every level and the (forward, reverse) tables of every
    conv: 'levels' (levels 1-4 and conv_out's), 'subm' (each level's
    submanifold tables), 'strided' (the tables of STRIDED's convs)."""
    nx, ny, nz = voxel_grid
    ids, bidx, _ = voxels
    lvl = Level(ids, bidx, (nx, ny, nz + 1))
    subm = ((3, 3, 3), (1, 1, 1), (1, 1, 1))
    out = {'subm': [conv_tables(lvl, lvl, *subm)], 'strided': [],
           'levels': [lvl]}
    for name, kernel, stride, pad, cap in STRIDED:
        nxt = strided_sites(lvl, batch, kernel, stride, pad,
                            None if cap is None else caps[cap])
        out['strided'].append(conv_tables(lvl, nxt, kernel, stride, pad))
        lvl = nxt
        out['levels'].append(lvl)
        if name != 'conv_out':
            out['subm'].append(conv_tables(lvl, lvl, *subm))
    return out


def backbone3d(name, params, stats, voxels, batch, voxel_grid, caps, train,
               prec):
    """voxels: (ids, bidx, features) of the batch's voxels -> (BEV map
    (B, nz_out * C_out, ny / 8, nx / 8), z-outer channels, the active site
    counts of every level)."""
    units, widths, c_out, residual = BACKBONES[name]
    lv = backbone_levels(voxels, batch, voxel_grid, caps)

    def conv(x, layer, table, relu=True):
        y = batch_norm(sparse_conv(x, table, kernel_of(params, layer), prec),
                       params, stats, f'backbone_3d.{layer}.MaskedBatchNorm_0',
                       train)
        return F.relu(y) if relu else y

    def unit(x, layer, table):
        if not residual:
            return conv(x, layer, table)
        h = conv(x, f'{layer}a', table)
        return F.relu(conv(h, f'{layer}b', table, relu=False) + x)

    x = conv(voxels[2], 'conv_input', lv['subm'][0])
    for li in range(4):
        if li:
            x = conv(x, STRIDED[li - 1][0], lv['strided'][li - 1])
        for j in range(units[li]):
            x = unit(x, f'conv{li + 1}_{j}', lv['subm'][li])
    x = conv(x, 'conv_out', lv['strided'][3])
    dense = densify(x, lv['levels'][4], batch)
    b, c, d, h, w = dense.shape
    bev = dense.permute(0, 2, 1, 3, 4).reshape(b, d * c, h, w)
    return bev, [len(v) for v in lv['levels']]


def voxelize_batch(points, points_mask, data_cfg, train):
    """The batch's voxels (ids, bidx, mean features) at the train or test
    budget."""
    proc = {p['NAME']: p for p in data_cfg['DATA_PROCESSOR']}
    vox = proc['transform_points_to_voxels']
    budget = vox['MAX_NUMBER_OF_VOXELS']['train' if train else 'test']
    out = [voxelize_mean(points[i], points_mask[i], vox['VOXEL_SIZE'],
                         data_cfg['POINT_CLOUD_RANGE'], budget,
                         vox['MAX_POINTS_PER_VOXEL'])
           for i in range(points.shape[0])]
    ids = torch.cat([o[0] for o in out])
    bidx = torch.cat([torch.full_like(o[0], i) for i, o in enumerate(out)])
    return (ids, bidx, torch.cat([o[1] for o in out])), budget


# ---------------------------------------------------------------------------
# BaseBEVBackbone
# ---------------------------------------------------------------------------

def bev_backbone(cfg2d, params, stats, x, train, prec):
    """x (B, C, H, W) -> the concatenated up-branches (B, sum(up), H', W');
    blocks ConvBlock_<i> in creation order: per level a strided conv,
    LAYER_NUMS convs, then the stride == kernel transposed conv."""
    n = 0

    def block(v, stride, pad, transpose=False):
        nonlocal n
        name = f'backbone_2d.ConvBlock_{n}'
        n += 1
        if transpose:
            w = params[f'{name}.ConvTranspose_0.weight']
            y = F.conv_transpose2d(prec.op2d(v), prec.op2d(w), stride=stride)
        else:
            w = params[f'{name}.Conv_0.weight']
            y = F.conv2d(prec.op2d(v), prec.op2d(w), stride=stride,
                         padding=pad)
        return F.relu(batch_norm(y, params, stats,
                                 f'{name}.MaskedBatchNorm_0', train,
                                 cdim=1))

    ups = []
    for i, layers in enumerate(cfg2d['LAYER_NUMS']):
        x = block(x, cfg2d['LAYER_STRIDES'][i], 1)
        for _ in range(layers):
            x = block(x, 1, 1)
        s = int(cfg2d['UPSAMPLE_STRIDES'][i])
        ups.append(block(x, s, 0, transpose=True))
    return torch.cat(ups, dim=1)
