"""PNG reading and writing on zlib and numpy (the machine with the card has
no Pillow): KITTI's `image_2` frames (8-bit RGB) and `depth_2` maps (16-bit
grey, metres x 256).

`read_png` decodes non-interlaced PNGs of every colour type (grey, RGB,
palette, grey + alpha, RGBA) at bit depths 1-16 with any mix of the five
row filters; it returns the samples as stored: (H, W) for grey, (H, W, C)
otherwise (a palette expanded to RGB), uint8 or, at 16 bits, uint16.
`encode_png` writes 8- or 16-bit grey, RGB or RGBA with one filter type
for every row (`write_png`: Sub).

Rows filtered only by None / Sub / Up are rebuilt row by row in numpy
(Sub as a running sum); with an Average or Paeth row, whose byte depends
on the rebuilt byte to its left, every row is rebuilt along anti-diagonals
of pixels, each of which depends only on the ones before it.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data):
    pos = len(SIGNATURE)
    while pos < len(data):
        length, = struct.unpack('>I', data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IEND':
            return


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filt, types, bpp):
    """Filtered rows (H, stride) of bytes -> the rebuilt rows, row by row
    (None, Sub, Up only)."""
    h, stride = filt.shape
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for r in range(h):
        row = filt[r].astype(np.int64)
        if types[r] == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1)
        elif types[r] == 2:
            row = row + prior
        prior = row & 0xFF
        out[r] = prior
    return out


def _unfilter_wavefront(filt, types, bpp):
    """Any filters: pixel (r, g) depends on (r, g - 1), (r - 1, g) and
    (r - 1, g - 1), so the pixels with r + g = d are rebuilt together."""
    h, stride = filt.shape
    n = stride // bpp
    f = filt.reshape(h, n, bpp).astype(np.int64)
    rec = np.zeros((h + 1, n + 1, bpp), np.int64)     # row 0, column 0: 0
    t = np.asarray(types)
    for d in range(h + n - 1):
        r = np.arange(max(0, d - n + 1), min(h - 1, d) + 1)
        g = d - r
        a, b, c = rec[r + 1, g], rec[r, g + 1], rec[r, g]
        tt = t[r][:, None]
        pred = np.where(tt == 1, a, np.where(tt == 2, b, np.where(
            tt == 3, (a + b) >> 1, np.where(tt == 4, _paeth(a, b, c), 0))))
        rec[r + 1, g + 1] = (f[r, g] + pred) & 0xFF
    return rec[1:, 1:].reshape(h, stride).astype(np.uint8)


def decode_png(data: bytes):
    """PNG bytes -> a numpy array (see the module docstring)."""
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG file')
    ihdr, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            ihdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(body)
    width, height, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise NotImplementedError('interlaced PNG')
    ch = _CHANNELS[ctype]
    bits = ch * depth
    stride = (width * bits + 7) // 8
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    raw = raw[:height * (stride + 1)].reshape(height, stride + 1)
    types, filt = raw[:, 0], raw[:, 1:]
    if types.max(initial=0) > 4:
        raise ValueError(f'unknown PNG filter type {types.max()}')
    unfilter = (_unfilter_wavefront if (types >= 3).any()
                else _unfilter_rows)
    rows = unfilter(filt, types, bpp)
    if depth == 16:
        px = rows.view('>u2').astype(np.uint16).reshape(height, width, ch)
    elif depth == 8:
        px = rows.reshape(height, width, ch)
    else:
        px = np.unpackbits(rows, axis=1).reshape(height, -1)[:, :width * bits]
        px = px.reshape(height, width, depth)
        px = (px * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(
            np.uint8)[..., None]
    if ctype == 3:
        return palette[px[..., 0]]
    return px[..., 0] if ch == 1 else px


def read_png(path):
    return decode_png(Path(path).read_bytes())


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(array, filter_type: int = 1) -> bytes:
    """(H, W) grey or (H, W, 3 | 4) uint8 / uint16 -> PNG bytes, every row
    with `filter_type` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    a = np.asarray(array)
    if a.dtype not in (np.uint8, np.uint16):
        raise TypeError(f'PNG samples must be uint8 or uint16, not {a.dtype}')
    h, w = a.shape[:2]
    ch = 1 if a.ndim == 2 else a.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    depth = 16 if a.dtype == np.uint16 else 8
    rows = (a.astype('>u2') if depth == 16 else a).reshape(h, -1)
    rows = np.frombuffer(rows.tobytes(), np.uint8).reshape(h, -1)
    bpp = ch * depth // 8
    x = rows.astype(np.int64)
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, upleft)}[filter_type]
    filt = ((x - pred) & 0xFF).astype(np.uint8)
    body = np.concatenate([np.full((h, 1), filter_type, np.uint8), filt], 1)
    return (SIGNATURE
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype, 0,
                                          0, 0))
            + _chunk(b'IDAT', zlib.compress(body.tobytes()))
            + _chunk(b'IEND', b''))


def write_png(path, array):
    Path(path).write_bytes(encode_png(array))


def png_size(path):
    """(height, width) from a PNG's header."""
    with open(path, 'rb') as f:
        head = f.read(24)
    if head[:8] != SIGNATURE:
        raise ValueError(f'{path} is not a PNG file')
    w, h = struct.unpack('>II', head[16:24])
    return h, w
