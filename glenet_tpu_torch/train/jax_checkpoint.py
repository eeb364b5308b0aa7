"""Reader for glenet_tpu's checkpoints (`checkpoint_epoch_N.msgpack`,
written by glenet_tpu/train/checkpoint.py with flax's msgpack_serialize),
without flax or the msgpack package.

The decoder covers msgpack's map, array, str, bin, int, float, nil and
bool formats and flax's ext types: 1, an ndarray (itself a msgpack of
(shape, dtype name, raw bytes), C order); 2, a native complex (a msgpack
of (real, imag)); 3, a numpy scalar (an ndarray of shape ()).  Arrays that
flax split into `__msgpack_chunked_array__` dicts (above 2**30 bytes) are
joined again.  numpy has no bfloat16, so bfloat16 arrays come back widened
to float32, which is exact.

The checkpoint's state['params'] and state['batch_stats'] go into the
port through utils/jax_weights.load_jax_variables.  Its optimizer state is
not mapped: resuming training from a .msgpack is not ported.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

PATTERN = 'checkpoint_epoch_*.msgpack'
CHUNKED = '__msgpack_chunked_array__'

# first byte -> struct format of the fixed-size value
_FIXED = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
          0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
# first byte -> struct format of the length of str / bin / array / map /
# ext
_LEN = {0xd9: '>B', 0xda: '>H', 0xdb: '>I', 0xc4: '>B', 0xc5: '>H',
        0xc6: '>I', 0xdc: '>H', 0xdd: '>I', 0xde: '>H', 0xdf: '>I',
        0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Decoder:
    """One msgpack message.  raw=True returns str payloads as bytes (flax
    decodes its ndarray tuples so)."""

    def __init__(self, data, raw=False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError('truncated msgpack message')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def decode(self):
        b = self.unpack('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.decode() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.text(b & 0x1f)
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _LEN:
            raise ValueError(f'byte 0x{b:02x} starts no msgpack object')
        n = self.unpack(_LEN[b])
        if b in (0xd9, 0xda, 0xdb):
            return self.text(n)
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(n))
        if b in (0xdc, 0xdd):
            return [self.decode() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(n)
        return self.ext(n)

    def text(self, n):
        data = bytes(self.take(n))
        return data if self.raw else data.decode('utf-8')

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.decode()
            out[k] = self.decode()
        return out

    def ext(self, n):
        code = self.unpack('>b')
        data = bytes(self.take(n))
        if code == 1:
            return _ndarray(data)
        if code == 2:
            re, im = unpackb(data)
            return complex(re, im)
        if code == 3:
            return _ndarray(data)[()]
        raise ValueError(f'msgpack ext type {code} is not one of flax\'s')


def _ndarray(data):
    shape, name, buf = unpackb(data, raw=True)
    if name == b'bfloat16':
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape).copy()


def unpackb(data, raw=False):
    """One msgpack message (bytes) -> Python objects (dicts, lists, str,
    bytes, int, float, None, bool, numpy arrays and scalars)."""
    dec = _Decoder(data, raw)
    out = dec.decode()
    if dec.pos != len(dec.buf):
        raise ValueError(f'{len(dec.buf) - dec.pos} bytes after the message')
    return out


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore, without flax."""
    return _unchunk(unpackb(data))


def load_checkpoint(path):
    """A glenet_tpu checkpoint -> {'epoch', 'it', 'state': {'params',
    'batch_stats', 'opt_state', 'step'}} of numpy arrays."""
    return msgpack_restore(Path(path).read_bytes())


def load_variables(net, ckpt):
    """Copy a loaded checkpoint's params and batch_stats into `net`."""
    from ..utils.jax_weights import load_jax_variables
    state = ckpt['state']
    load_jax_variables(net, {'params': state['params'],
                             'batch_stats': state.get('batch_stats', {})})


def build_detector_from_checkpoint(cfg, path, device=None):
    """The port's detector for `cfg` with the weights of a glenet_tpu
    checkpoint; on the GPU unless device='cpu' (without a GPU it raises)."""
    from ..models.detectors import build_detector
    detector = build_detector(cfg, device=device)
    load_variables(detector.net, load_checkpoint(path))
    return detector
