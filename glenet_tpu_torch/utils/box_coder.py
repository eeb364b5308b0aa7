"""Box coder (torch counterpart of glenet_tpu/utils/box_coder.py
ResidualCoder): xyz residuals normalized by the anchor BEV diagonal / dz,
log-ratio dims, heading as a delta."""
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


def build_box_coder(name: str, **kwargs):
    if name != 'ResidualCoder' or kwargs:
        raise NotImplementedError(f'box coder {name} {kwargs} is not ported '
                                  f'yet')
    return ResidualCoder()
