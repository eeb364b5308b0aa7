"""Box coders (torch counterparts of glenet_tpu/utils/box_coder.py):
ResidualCoder (xyz residuals normalized by the anchor BEV diagonal / dz,
log-ratio dims, heading as a delta or as a cos / sin difference),
PointResidualCoder (boxes against per-point locations with class-mean
sizes, heading as cos / sin) and the legacy PreviousResidualDecoder."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ResidualCoder:
    """With encode_angle_by_sincos the heading is encoded as (cos rg -
    cos ra, sin rg - sin ra) and decoded by atan2, and code_size is one
    more than given (8 by default)."""
    code_size: int = 7
    encode_angle_by_sincos: bool = False

    def __post_init__(self):
        if self.encode_angle_by_sincos:
            object.__setattr__(self, 'code_size', self.code_size + 1)

    def encode(self, boxes, anchors):
        """boxes, anchors: (..., 7 + C) -> (..., code_size + C) residuals;
        sizes are clamped at 1e-5 before the log ratios."""
        def split(b):
            return (*b[..., :3].unbind(-1),
                    *b[..., 3:6].clamp_min(1e-5).unbind(-1), b[..., 6])

        xa, ya, za, dxa, dya, dza, ra = split(anchors)
        xg, yg, zg, dxg, dyg, dzg, rg = split(boxes)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra),
                   torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        return torch.cat([torch.stack([
            (xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
            *rts], dim=-1), boxes[..., 7:] - anchors[..., 7:]], dim=-1)

    def decode(self, box_encodings, anchors):
        """box_encodings: (..., code_size + C), anchors: (..., 7 + C) ->
        (..., 7 + C) boxes."""
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xt, yt, zt, dxt, dyt, dzt = box_encodings[..., :6].unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            cost, sint = box_encodings[..., 6:8].unbind(-1)
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
            extras = box_encodings[..., 8:] + anchors[..., 7:]
        else:
            rg = box_encodings[..., 6] + ra
            extras = box_encodings[..., 7:] + anchors[..., 7:]
        return torch.cat([torch.stack([
            xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
            torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza,
            rg], dim=-1), extras], dim=-1)


@dataclasses.dataclass(frozen=True)
class PreviousResidualDecoder:
    """The legacy decoder of SECOND-v1-era models (reference
    box_coder_utils.py:80-112): ResidualCoder's decode with the size codes
    in (w, l, h) order, each scaling the anchor's dy, dx, dz."""
    code_size: int = 7

    @staticmethod
    def decode(box_encodings, anchors):
        """box_encodings (..., 7), anchors (..., 7+) -> (..., 7) boxes."""
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xt, yt, zt, wt, lt, ht, rt = box_encodings[..., :7].unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
            torch.exp(lt) * dxa, torch.exp(wt) * dya, torch.exp(ht) * dza,
            rt + ra], dim=-1)


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
           'PointResidualCoder': PointResidualCoder,
           'PreviousResidualDecoder': PreviousResidualDecoder}


def build_box_coder(name: str, **kwargs):
    if name not in _CODERS:
        raise NotImplementedError(f'unknown box coder {name!r}')
    if 'mean_size' in kwargs:
        kwargs['mean_size'] = tuple(tuple(m) for m in kwargs['mean_size'])
    return _CODERS[name](**kwargs)
