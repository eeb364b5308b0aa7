"""DeepLabV3-ResNet depth-distribution network, CaDDN's reference DDN
(torch counterpart of glenet_tpu/models/ddn_deeplab.py).

torchvision's deeplabv3_resnet50 / 101 topology on NCHW tensors:

  - ResNet with replace_stride_with_dilation = [False, True, True]: conv1
    7 x 7 / 2 -> BN -> ReLU -> maxpool 3 x 3 / 2 -> layer1 (stride 4) ->
    layer2 / 2 -> layer3 (dilation 2) -> layer4 (dilation 4), output
    stride 8;
  - DeepLabHead: ASPP(2048, rates 12 / 24 / 36; 1 x 1, three dilated 3 x 3
    and a global-pool branch, each 256 + BN + ReLU, concatenated, then a
    1 x 1 projection + BN + ReLU; torchvision's Dropout(0.5) left out, as
    in glenet_tpu) -> 3 x 3 conv 256 + BN + ReLU -> 1 x 1 conv to
    num_bins + 1 logits, bilinearly upsampled (half-pixel) to layer1's
    size;
  - with `normalize_input` (on in ImageVFE) the images are normalised by
    ImageNet's mean and std first.

Returns layer1's features (B, 256, H/4, W/4) and the logits.  Attribute
names follow the JAX variable paths (`backbone.layer3_5.conv2`, each BN as
`bn1.BatchNorm_0`), so utils/jax_weights.py maps them;
utils/weight_converter.convert_ddn_deeplabv3 maps torchvision's names.

`BatchNorm` is flax's nn.BatchNorm as glenet_tpu's `_BN` configures it:
eps 1e-5, the running stats moved by 0.1 of the batch's (flax momentum
0.9), the biased batch variance, and no masking; it ignores
layers.BN_FORCE_RUNNING_STATS, as flax's BatchNorm does.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import distributed as dp

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RESNET_BLOCKS = {'ResNet50': (3, 4, 6, 3), 'ResNet101': (3, 4, 23, 3)}


class BatchNorm(nn.Module):
    """Plain BatchNorm over dim 1 (flax nn.BatchNorm: eps 1e-5, running
    stats new = 0.9 old + 0.1 batch, biased variance)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x, train: bool = False):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            dims = [0] + list(range(2, x.dim()))
            mean, mean_sq = x.mean(dims), (x * x).mean(dims)
            world = dp.data_rows()[1]
            if world > 1:
                # the global batch's moments: every rank holds as many rows
                mean, mean_sq = (t / world for t in
                                 dp.sum_moments(mean, mean_sq))
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + \
            self.bias.reshape(shape)


class _BN(nn.Module):
    """glenet_tpu's `_BN` wrapper: its BatchNorm sits at `BatchNorm_0`."""

    def __init__(self, features: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x, train: bool = False):
        return self.BatchNorm_0(x, train)


def _conv(cin, cout, k, stride=1, dilation=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _BN(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = _BN(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = _BN(planes * 4)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = _conv(inplanes, planes * 4, 1, stride)
            self.downsample_bn = _BN(planes * 4)

    def forward(self, x, train: bool = False):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        sc = (self.downsample_bn(self.downsample_conv(x), train)
              if self.has_downsample else x)
        return F.relu(out + sc)


# (planes, first block's stride, first dilation, the others' dilation)
_LAYER_SPECS = ((64, 1, 1, 1), (128, 2, 1, 1), (256, 1, 1, 2),
                (512, 1, 2, 4))


class ResNetDeepLabTrunk(nn.Module):
    """ResNet-50 / 101 with DeepLabV3's dilations; returns layer1 (stride
    4) and layer4 (stride 8).  Blocks are `layer<l>_<b>`."""

    def __init__(self, blocks: Tuple[int, int, int, int] = (3, 4, 23, 3)):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _BN(64)
        self.names = []
        inplanes = 64
        for li, ((planes, stride, d_first, d_rest), n) in enumerate(
                zip(_LAYER_SPECS, blocks), start=1):
            names = []
            for bi in range(n):
                name = f'layer{li}_{bi}'
                setattr(self, name, Bottleneck(
                    inplanes, planes, stride if bi == 0 else 1,
                    d_first if bi == 0 else d_rest, has_downsample=bi == 0))
                inplanes = planes * 4
                names.append(name)
            self.names.append(names)

    def forward(self, x, train: bool = False):
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for names in self.names:
            for name in names:
                x = getattr(self, name)(x, train)
            feats.append(x)
        return feats[0], feats[3]


class ASPP(nn.Module):
    def __init__(self, in_channels: int = 2048,
                 rates: Sequence[int] = (12, 24, 36), channels: int = 256):
        super().__init__()
        self.rates = tuple(rates)
        self.conv0 = _conv(in_channels, channels, 1)
        self.bn0 = _BN(channels)
        for i, r in enumerate(self.rates, start=1):
            setattr(self, f'conv{i}', _conv(in_channels, channels, 3, 1, r))
            setattr(self, f'bn{i}', _BN(channels))
        self.conv_pool = _conv(in_channels, channels, 1)
        self.bn_pool = _BN(channels)
        self.project = _conv(channels * (len(self.rates) + 2), channels, 1)
        self.project_bn = _BN(channels)

    def forward(self, x, train: bool = False):
        outs = [F.relu(self.bn0(self.conv0(x), train))]
        for i in range(1, len(self.rates) + 1):
            conv, bn = getattr(self, f'conv{i}'), getattr(self, f'bn{i}')
            outs.append(F.relu(bn(conv(x), train)))
        # global-pool branch: a 1 x 1 map upsampled = tiled
        p = self.conv_pool(x.mean(dim=(2, 3), keepdim=True))
        p = F.relu(self.bn_pool(p, train))
        outs.append(p.expand(-1, -1, *x.shape[2:]))
        h = self.project(torch.cat(outs, dim=1))
        return F.relu(self.project_bn(h, train))


class DDNDeepLabV3(nn.Module):
    """(B, 3, H, W) images -> features (B, 256, H/4, W/4) and depth logits
    (B, num_bins + 1, H/4, W/4)."""

    num_features = 256

    def __init__(self, num_bins: int,
                 blocks: Tuple[int, int, int, int] = (3, 4, 23, 3),
                 normalize_input: bool = True):
        super().__init__()
        self.normalize_input = normalize_input
        self.backbone = ResNetDeepLabTrunk(tuple(blocks))
        self.aspp = ASPP()
        self.head_conv = _conv(256, 256, 3)
        self.head_bn = _BN(256)
        self.head_out = _conv(256, num_bins + 1, 1, bias=True)
        self.register_buffer('mean', torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer('std', torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, images, train: bool = False):
        x = images
        if self.normalize_input:
            x = (x - self.mean[:, None, None]) / self.std[:, None, None]
        features, deep = self.backbone(x, train)
        h = self.aspp(deep, train)
        h = F.relu(self.head_bn(self.head_conv(h), train))
        logits = self.head_out(h)
        # half-pixel bilinear; upsampling, so jax.image.resize's
        # antialiasing does nothing
        logits = F.interpolate(logits, size=features.shape[2:],
                               mode='bilinear', align_corners=False)
        return features, logits
