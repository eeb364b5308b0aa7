"""CaDDN's camera path (torch counterpart of glenet_tpu/models/image_vfe.py):
ImageVFE (depth-distribution frustum features and frustum-to-voxel
sampling), Conv2DCollapse and the depth loss.

  - a depth-distribution network (DDNLite, or DDNDeepLabV3 with the
    config's CHANNEL_REDUCE block) gives per-pixel depth-bin logits (D + 1
    classes, the last out of range) and an image feature map at 1/4 of the
    image;
  - frustum features = features x the softmax depth probabilities, a
    (B, D, h, w, C) volume;
  - every voxel centre is projected lidar -> camera -> image, its metric
    depth turned into a continuous bin coordinate (bin_depths: UD, LID or
    SID) and the volume sampled trilinearly (zero outside) through a bf16
    copy of it; centres behind the camera get bin -10 (outside), and pixel
    v maps to feature row v / ds - 0.5;
  - Conv2DCollapse folds the voxel z axis into the channels and applies a
    1 x 1 conv block;
  - ddn_loss: focal cross-entropy over the depth bins, foreground and
    background pixels (inside a projected 2-D gt box or not) balanced.

The sampling runs as a plain torch function on every device (there is no
TPU kernel on this path): each of the 8 corners is gathered from the bf16
copy and upcast before its f32 weight multiplies it, in glenet_tpu's corner
order, in chunks of the centres.  Its backward keeps only the corners'
indices and weights and sums each corner's contribution into an f32
buffer (glenet_tpu sums the cotangent of its bf16 gather in bf16).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Cfg
from ..parallel import distributed as dp
from .layers import ConvBlock, MaskedBatchNorm

GATHER_DTYPE = torch.bfloat16
CHUNKS = 8


# ---------------------------------------------------------------------------
# depth discretization
# ---------------------------------------------------------------------------

def bin_depths(depth_map, mode, depth_min, depth_max, num_bins,
               target=False):
    """Metric depth -> continuous bin coordinates, or with `target` the
    integer bin (num_bins for out of range or not finite).  A division by
    a constant is a product with its f32 reciprocal, as XLA computes it."""
    if mode == 'UD':
        bin_size = (depth_max - depth_min) / num_bins
        indices = (depth_map - depth_min) * _recip(bin_size)
    elif mode == 'LID':
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        indices = -0.5 + 0.5 * torch.sqrt(torch.clamp_min(
            1 + 8 * (depth_map - depth_min) * _recip(bin_size), 0.0))
    elif mode == 'SID':
        indices = num_bins * (torch.log(1 + depth_map)
                              - math.log(1 + depth_min)) * _recip(
            math.log(1 + depth_max) - math.log(1 + depth_min))
    else:
        raise NotImplementedError(f'depth discretization {mode}')
    if target:
        oob = (indices < 0) | (indices > num_bins) | ~torch.isfinite(indices)
        indices = torch.where(oob, float(num_bins), indices)
        indices = torch.floor(indices).long()
    return indices


def _recip(x):
    return float(np.float32(1.0) / np.float32(x))


# ---------------------------------------------------------------------------
# depth distribution network (DeepLabV3 stand-in)
# ---------------------------------------------------------------------------

class DDNLite(nn.Module):
    """(B, 3, H, W) images -> features (B, feat_ch, H/4, W/4) and depth
    logits (B, num_bins + 1, H/4, W/4).  Children follow the JAX module's
    auto names (ConvBlock_<i>, Dense_<i>, Conv_<i>, MaskedBatchNorm_<i>)."""

    def __init__(self, num_bins: int, feat_ch: int = 64, width: int = 32):
        super().__init__()
        w2 = width * 2
        self.ConvBlock_0 = ConvBlock(3, width, 7, 2, padding=3)
        self.ConvBlock_1 = ConvBlock(width, width, 3, 2, padding=1)
        self.ConvBlock_2 = ConvBlock(width, w2, 3, 1, padding=1)
        self.ConvBlock_3 = ConvBlock(w2, w2, 3, 1, padding=1, use_relu=False)
        self.Dense_0 = nn.Linear(width, w2)     # the first skip's widening
        self.ConvBlock_4 = ConvBlock(w2, w2, 3, 1, padding=1)
        self.ConvBlock_5 = ConvBlock(w2, w2, 3, 1, padding=1, use_relu=False)
        self.ConvBlock_6 = ConvBlock(w2, feat_ch, 1, 1, padding=0)
        # dilated tail + ASPP-lite for the depth head
        self.Conv_0 = nn.Conv2d(w2, w2, 3, padding=2, dilation=2, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(w2, channel_dim=1)
        self.Conv_1 = nn.Conv2d(w2, w2, 3, padding=4, dilation=4, bias=False)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(w2, channel_dim=1)
        self.Dense_1 = nn.Linear(w2, w2)
        self.Conv_2 = nn.Conv2d(2 * w2, num_bins + 1, 1)

    def forward(self, images, train: bool = False):
        x = self.ConvBlock_1(self.ConvBlock_0(images, train), train)
        h = self.ConvBlock_3(self.ConvBlock_2(x, train), train)
        x = F.relu(h + self.Dense_0(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
        h = self.ConvBlock_5(self.ConvBlock_4(x, train), train)
        x = F.relu(h + x)
        feat = self.ConvBlock_6(x, train)
        d = x
        for conv, bn in ((self.Conv_0, self.MaskedBatchNorm_0),
                         (self.Conv_1, self.MaskedBatchNorm_1)):
            d = F.relu(bn(conv(d), use_running_average=not train))
        pooled = self.Dense_1(d.mean(dim=(2, 3)))[..., None, None]
        d = torch.cat([d, pooled.expand(-1, -1, *d.shape[2:])], dim=1)
        return feat, self.Conv_2(d)


# ---------------------------------------------------------------------------
# frustum -> voxel sampling
# ---------------------------------------------------------------------------

def trilinear_corners(coords, shape):
    """coords (N, 3) as (d, v, u) float indices into a (D, H, W) volume ->
    (idx (8, N) int32 rows of the flattened volume, D * H * W for a corner
    outside it; wgt (8, N) f32, 0 outside), corners in the order
    (dz, dy, dx) = 000, 001, 010, ..., 111."""
    d, h, w = shape
    cd, cv, cu = coords[:, 0], coords[:, 1], coords[:, 2]
    d0, v0, u0 = torch.floor(cd), torch.floor(cv), torch.floor(cu)
    idxs, wgts = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                zi, yi, xi = d0 + dz, v0 + dy, u0 + dx
                wgt = ((1 - torch.abs(cd - zi)) * (1 - torch.abs(cv - yi))
                       * (1 - torch.abs(cu - xi)))
                inb = ((zi >= 0) & (zi < d) & (yi >= 0) & (yi < h)
                       & (xi >= 0) & (xi < w))
                idxs.append(torch.where(inb, (zi * h + yi) * w + xi,
                                        float(d * h * w)).int())
                wgts.append(torch.where(inb, wgt, 0.0))
    return torch.stack(idxs), torch.stack(wgts).float()


def accumulate_volume_grad(idx, wgt, grad_out, n_rows, chunks=CHUNKS):
    """The sampler's backward: sum of grad_out[n] * wgt[k, n] into row
    idx[k, n] of an f32 (n_rows, C) buffer, corner by corner, chunk by
    chunk."""
    buf = grad_out.new_zeros((n_rows, grad_out.shape[1]), dtype=torch.float32)
    n = grad_out.shape[0]
    per = -(-n // chunks)
    g32 = grad_out.float()
    for s in range(0, n, per):
        g = g32[s:s + per]
        for k in range(idx.shape[0]):
            buf.index_add_(0, idx[k, s:s + per], g * wgt[k, s:s + per, None])
    return buf


class _TrilinearSample(torch.autograd.Function):
    """volume (D, H, W, C) -> (N, C); saves only the corners' (idx, wgt)."""

    @staticmethod
    def forward(ctx, volume, idx, wgt, gather_dtype, chunks):
        d, h, w, c = volume.shape
        flat = volume.reshape(-1, c)
        if gather_dtype is not None:
            flat = flat.to(gather_dtype)
        padded = torch.cat([flat, flat.new_zeros((1, c))])
        n = idx.shape[1]
        out = volume.new_empty((n, c))
        per = -(-n // chunks)
        for s in range(0, n, per):
            acc = volume.new_zeros((min(per, n - s), c))
            for k in range(idx.shape[0]):
                acc = acc + (padded.index_select(0, idx[k, s:s + per])
                             .to(volume.dtype) * wgt[k, s:s + per, None])
            out[s:s + per] = acc
        ctx.save_for_backward(idx, wgt)
        ctx.shape = volume.shape
        ctx.chunks = chunks
        return out

    @staticmethod
    def backward(ctx, grad_out):
        idx, wgt = ctx.saved_tensors
        d, h, w, c = ctx.shape
        buf = accumulate_volume_grad(idx, wgt, grad_out, d * h * w + 1,
                                     ctx.chunks)
        return buf[:-1].reshape(d, h, w, c), None, None, None, None


def trilinear_sample(volume, coords, gather_dtype=None, chunks=CHUNKS):
    """volume (D, H, W, C); coords (N, 3) as (d, v, u) float indices ->
    (N, C), zero outside.  With `gather_dtype` the corners are gathered
    from a copy of the volume in that dtype and upcast before the weight
    multiplies them."""
    with torch.no_grad():
        idx, wgt = trilinear_corners(coords.float(), volume.shape[:3])
    chunks = max(1, min(int(chunks), coords.shape[0]))
    return _TrilinearSample.apply(volume, idx, wgt.to(volume.dtype),
                                  gather_dtype, chunks)


def voxel_grid_centers(grid_size, pc_range):
    """(X*Y*Z, 3) lidar-frame voxel centres, x-major ((X, Y, Z) order)."""
    nx, ny, nz = grid_size
    pc_range = np.asarray(pc_range, np.float32)
    vs = (pc_range[3:6] - pc_range[0:3]) / np.asarray([nx, ny, nz])
    xs = pc_range[0] + (np.arange(nx) + 0.5) * vs[0]
    ys = pc_range[1] + (np.arange(ny) + 0.5) * vs[1]
    zs = pc_range[2] + (np.arange(nz) + 0.5) * vs[2]
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing='ij')
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


def frustum_coords(centers, lidar_to_cam, cam_to_img, disc, num_bins, ds_h,
                   ds_w):
    """One sample's voxel centres (N, 3) -> (N, 3) (bin, row, column)
    coordinates in its frustum volume; a centre behind the camera gets bin
    -10."""
    ones = centers.new_ones((centers.shape[0], 1))
    cam = (lidar_to_cam @ torch.cat([centers, ones], 1).T).T[:, :3]
    img = (cam_to_img @ torch.cat([cam, ones], 1).T).T
    depth = img[:, 2]
    u = img[:, 0] / torch.clamp_min(depth, 1e-6)
    v = img[:, 1] / torch.clamp_min(depth, 1e-6)
    dbin = bin_depths(depth, disc['mode'], float(disc['depth_min']),
                      float(disc['depth_max']), num_bins)
    return torch.stack([torch.where(depth > 0, dbin, -10.0),
                        v / ds_h - 0.5, u / ds_w - 0.5], dim=1)


class ImageVFE(nn.Module):
    """model_cfg = MODEL.VFE (its FFN and F2V sections)."""

    def __init__(self, model_cfg, grid_size, pc_range):
        super().__init__()
        mcfg = Cfg(model_cfg)
        self.disc = dict(mcfg.FFN.DISCRETIZE)
        self.num_bins = int(self.disc['num_bins'])
        cr = mcfg.FFN.CHANNEL_REDUCE
        self.grid_size = tuple(int(g) for g in grid_size)
        ddn_name = str(mcfg.FFN.DDN.get('NAME', 'DDNLite'))
        self.channel_reduce = None
        if ddn_name == 'DDNDeepLabV3':
            from .ddn_deeplab import RESNET_BLOCKS, DDNDeepLabV3
            backbone = str(mcfg.FFN.DDN.get('BACKBONE_NAME', 'ResNet101'))
            if backbone not in RESNET_BLOCKS:
                raise NotImplementedError(f'DDN backbone {backbone}')
            self.ddn = DDNDeepLabV3(self.num_bins, RESNET_BLOCKS[backbone])
            self.channel_reduce = ConvBlock(
                self.ddn.num_features, int(cr['out_channels']),
                int(cr.get('kernel_size', 1)), int(cr.get('stride', 1)),
                padding=0)
        elif ddn_name == 'DDNLite':
            self.ddn = DDNLite(self.num_bins, feat_ch=int(cr['out_channels']))
        else:
            raise NotImplementedError(f'DDN {ddn_name}')
        self.num_features = int(cr['out_channels'])
        self.register_buffer('centers', torch.from_numpy(
            voxel_grid_centers(self.grid_size, pc_range)), persistent=False)

    def forward(self, images, lidar_to_cam, cam_to_img, image_shape,
                train: bool = False):
        """images (B, H, W, 3); lidar_to_cam (B, 4, 4); cam_to_img
        (B, 3, 4); image_shape (B, 2) (unused, as in glenet_tpu).  Returns
        voxel_features (B, X, Y, Z, C) and depth_logits (B, h, w, D + 1)
        (a channels-last view)."""
        feat, logits = self.ddn(images.permute(0, 3, 1, 2), train)
        if self.channel_reduce is not None:
            feat = self.channel_reduce(feat, train)
        probs = torch.softmax(logits, dim=1)[:, :self.num_bins]
        # frustum volume (B, D, h, w, C)
        frustum = feat.permute(0, 2, 3, 1)[:, None] * probs[..., None]
        hs, ws = feat.shape[2:]
        ds_h, ds_w = images.shape[1] / hs, images.shape[2] / ws
        vox = torch.stack([
            trilinear_sample(frustum[i], frustum_coords(
                self.centers, lidar_to_cam[i], cam_to_img[i], self.disc,
                self.num_bins, ds_h, ds_w), gather_dtype=GATHER_DTYPE)
            for i in range(images.shape[0])])
        return {'voxel_features': vox.reshape(vox.shape[0], *self.grid_size,
                                              vox.shape[-1]),
                'depth_logits': logits.permute(0, 2, 3, 1)}


class Conv2DCollapse(nn.Module):
    """Fold z into the channels (channel z * C + c) + a 1 x 1 conv block:
    (B, X, Y, Z, C) -> (B, Y, X, num_bev_features), a channels-last view.
    The 1 x 1 conv runs as one matmul over the (B, X, Y, Z * C) rows of the
    sampled features, as they lie."""

    def __init__(self, in_channels: int, num_bev_features: int):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(in_channels, num_bev_features, 1, 1,
                                     padding=0)

    def forward(self, voxel_features, train: bool = False):
        b, x, y, z, c = voxel_features.shape
        blk = self.ConvBlock_0
        out = F.linear(voxel_features.reshape(b, x, y, z * c),
                       blk.Conv_0.weight.flatten(1))     # (B, X, Y, F)
        out = blk.MaskedBatchNorm_0(out.permute(0, 3, 2, 1),
                                    use_running_average=not train)
        return F.relu(out).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# DDN loss
# ---------------------------------------------------------------------------

def ddn_loss(depth_logits, depth_maps, gt_boxes2d, gt_boxes2d_mask, disc_cfg,
             weight=3.0, alpha=0.25, gamma=2.0, fg_weight=13.0,
             bg_weight=1.0):
    """Focal cross-entropy over the depth bins with fg / bg pixel balancing.

    depth_logits (B, h, w, D + 1); depth_maps (B, h, w) metric;
    gt_boxes2d (B, N, 4) [x1, y1, x2, y2] at feature-map scale."""
    num_bins = depth_logits.shape[-1] - 1
    target = bin_depths(depth_maps, disc_cfg['mode'],
                        float(disc_cfg['depth_min']),
                        float(disc_cfg['depth_max']), num_bins, target=True)
    logp = torch.log_softmax(depth_logits, dim=-1).gather(
        -1, target[..., None])[..., 0]
    pt = torch.exp(logp)
    focal = alpha * (1 - pt) ** gamma * -logp               # (B, h, w)

    b, h, w = focal.shape
    ys = torch.arange(h, device=focal.device)[None, :, None, None]
    xs = torch.arange(w, device=focal.device)[None, None, :, None]
    boxes = gt_boxes2d[:, None, None]                       # (B, 1, 1, N, 4)
    inside = ((xs >= boxes[..., 0]) & (xs < boxes[..., 2])
              & (ys >= boxes[..., 1]) & (ys < boxes[..., 3])
              & gt_boxes2d_mask[:, None, None, :])
    fg_mask = inside.any(-1)                                # (B, h, w)
    num_fg = dp.global_count(fg_mask.sum()).clamp_min(1)
    num_bg = dp.global_count((~fg_mask).sum()).clamp_min(1)
    fg = (focal * fg_mask).sum() / num_fg * fg_weight
    bg = (focal * ~fg_mask).sum() / num_bg * bg_weight
    return (fg + bg) / (fg_weight + bg_weight) * weight
