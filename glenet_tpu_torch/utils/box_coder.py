"""Box coders (torch counterparts of glenet_tpu/utils/box_coder.py):
ResidualCoder (xyz residuals normalized by the anchor BEV diagonal / dz,
log-ratio dims, heading as a delta) and PointResidualCoder (boxes against
per-point locations with class-mean sizes, heading as cos / sin)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ResidualCoder:
    code_size: int = 7

    def encode(self, boxes, anchors):
        """boxes, anchors: (..., 7 + C) -> (..., 7 + C) residuals; sizes are
        clamped at 1e-5 before the log ratios."""
        def split(b):
            return (*b[..., :3].unbind(-1),
                    *b[..., 3:6].clamp_min(1e-5).unbind(-1), b[..., 6])

        xa, ya, za, dxa, dya, dza, ra = split(anchors)
        xg, yg, zg, dxg, dyg, dzg, rg = split(boxes)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.cat([torch.stack([
            (xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
            rg - ra], dim=-1), boxes[..., 7:] - anchors[..., 7:]], dim=-1)

    def decode(self, box_encodings, anchors):
        """box_encodings: (..., 7 + C), anchors: (..., 7 + C) -> boxes."""
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xt, yt, zt, dxt, dyt, dzt, rt = box_encodings[..., :7].unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        extras = box_encodings[..., 7:] + anchors[..., 7:]
        return torch.cat([torch.stack([
            xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
            torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza,
            rt + ra], dim=-1), extras], dim=-1)


@dataclasses.dataclass(frozen=True)
class PointResidualCoder:
    """Point-head coder (reference box_coder_utils.py:146-222): encodes gt
    boxes against points; with use_mean_size the residuals are normalized
    by the mean size of the box's class (1-based class ids)."""
    code_size: int = 8
    use_mean_size: bool = True
    mean_size: tuple = ()

    def _anchor_sizes(self, classes, like):
        mean = torch.as_tensor(self.mean_size, dtype=torch.float32,
                               device=like.device)[classes.long() - 1]
        return mean.unbind(-1)

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt_boxes (..., 7), points (..., 3+), gt_classes (...) ->
        (..., 8) encodings; sizes clamped at 1e-5."""
        xg, yg, zg = gt_boxes[..., :3].unbind(-1)
        dxg, dyg, dzg = gt_boxes[..., 3:6].clamp_min(1e-5).unbind(-1)
        rg = gt_boxes[..., 6]
        xa, ya, za = points[..., :3].unbind(-1)
        if self.use_mean_size:
            dxa, dya, dza = self._anchor_sizes(gt_classes, gt_boxes)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            res = [(xg - xa) / diagonal, (yg - ya) / diagonal,
                   (zg - za) / dza, torch.log(dxg / dxa),
                   torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            res = [xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg),
                   torch.log(dzg)]
        return torch.stack(res + [torch.cos(rg), torch.sin(rg)], dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        """box_encodings (..., 8), points (..., 3+), pred_classes (...) ->
        (..., 7) boxes."""
        xt, yt, zt, dxt, dyt, dzt, cost, sint = box_encodings[..., :8].unbind(
            -1)
        xa, ya, za = points[..., :3].unbind(-1)
        if self.use_mean_size:
            dxa, dya, dza = self._anchor_sizes(pred_classes, box_encodings)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            res = [xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                   torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
                   torch.exp(dzt) * dza]
        else:
            res = [xt + xa, yt + ya, zt + za, torch.exp(dxt), torch.exp(dyt),
                   torch.exp(dzt)]
        return torch.stack(res + [torch.atan2(sint, cost)], dim=-1)


_CODERS = {'ResidualCoder': ResidualCoder,
           'PointResidualCoder': PointResidualCoder}


def build_box_coder(name: str, **kwargs):
    if name not in _CODERS or (name == 'ResidualCoder' and kwargs):
        raise NotImplementedError(f'box coder {name} {kwargs} is not ported '
                                  f'yet')
    if 'mean_size' in kwargs:
        kwargs['mean_size'] = tuple(tuple(m) for m in kwargs['mean_size'])
    return _CODERS[name](**kwargs)
