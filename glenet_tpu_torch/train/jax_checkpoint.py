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
port through utils/jax_weights.load_jax_variables, and its
state['opt_state'] (optax's state of glenet_tpu/train/optim.py's chain,
flattened by flax's to_state_dict) into the state of the port's
train/optim.py optimizer (`opt_state_from_jax`), so training resumes from a
.msgpack.  The other way, `checkpoint_state` and `save_checkpoint` write a
port train state as a glenet_tpu checkpoint (`packb` is flax's
msgpack_serialize, without flax; arrays above 2**30 bytes, which flax would
split into chunks, raise).
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


class _Encoder:
    """msgpack's encoding as flax's msgpack_serialize writes it
    (msgpack-python's packer with use_bin_type and strict_types, after a
    tree map that sorts dict keys): the smallest format for each int,
    float64 for floats, numpy arrays as ext type 1 and numpy scalars as
    ext type 3."""

    def __init__(self):
        self.out = bytearray()

    def head(self, n, fix_base, fix_max, codes):
        """The header of a str / bin / array / map / ext of length n."""
        if fix_base is not None and n <= fix_max:
            self.out.append(fix_base | n)
            return
        for (code, fmt), limit in zip(codes, (0xff, 0xffff, 0xffffffff)):
            if code is not None and n <= limit:
                self.out += struct.pack(f'>B{fmt}', code, n)
                return
        raise ValueError(f'msgpack object of length {n} is too long')

    def encode(self, obj):
        if isinstance(obj, (np.ndarray, np.generic)):
            # before float: np.float64 subclasses it, and flax's strict
            # types send every numpy scalar to ext type 3
            arr = np.asarray(obj)
            if arr.nbytes > 2 ** 30:
                raise ValueError(f'array of {arr.nbytes} bytes: flax would '
                                 f'split it into chunks')
            self.ext(1 if isinstance(obj, np.ndarray) else 3, packb(
                (arr.shape, arr.dtype.name, arr.tobytes('C'))))
        elif obj is None or isinstance(obj, bool):
            self.out.append({None: 0xc0, False: 0xc2, True: 0xc3}[obj])
        elif isinstance(obj, int):
            self.integer(obj)
        elif isinstance(obj, float):
            self.out += struct.pack('>Bd', 0xcb, obj)
        elif isinstance(obj, str):
            data = obj.encode('utf-8')
            self.head(len(data), 0xa0, 31,
                      ((0xd9, 'B'), (0xda, 'H'), (0xdb, 'I')))
            self.out += data
        elif isinstance(obj, (bytes, bytearray)):
            self.head(len(obj), None, 0,
                      ((0xc4, 'B'), (0xc5, 'H'), (0xc6, 'I')))
            self.out += obj
        elif isinstance(obj, dict):
            self.head(len(obj), 0x80, 15, ((None, 'B'), (0xde, 'H'),
                                           (0xdf, 'I')))
            for k in sorted(obj):      # flax maps the tree: keys sorted
                self.encode(k)
                self.encode(obj[k])
        elif isinstance(obj, (list, tuple)):
            self.head(len(obj), 0x90, 15, ((None, 'B'), (0xdc, 'H'),
                                           (0xdd, 'I')))
            for v in obj:
                self.encode(v)
        else:
            raise TypeError(f'cannot encode {type(obj).__name__}')

    def integer(self, v):
        if 0 <= v < 0x80 or -0x20 <= v < 0:
            self.out += struct.pack('>b' if v < 0 else '>B', v)
            return
        for lo, hi, code, fmt in (
                (0, 0xff, 0xcc, 'B'), (-0x80, -1, 0xd0, 'b'),
                (0, 0xffff, 0xcd, 'H'), (-0x8000, -1, 0xd1, 'h'),
                (0, 0xffffffff, 0xce, 'I'), (-0x80000000, -1, 0xd2, 'i'),
                (0, 0xffffffffffffffff, 0xcf, 'Q'),
                (-0x8000000000000000, -1, 0xd3, 'q')):
            if lo <= v <= hi:
                self.out += struct.pack(f'>B{fmt}', code, v)
                return
        raise ValueError(f'int {v} does not fit msgpack')

    def ext(self, code, data):
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if len(data) in fixext:
            self.out.append(fixext[len(data)])
        else:
            self.head(len(data), None, 0,
                      ((0xc7, 'B'), (0xc8, 'H'), (0xc9, 'I')))
        self.out += struct.pack('>b', code) + data


def packb(obj) -> bytes:
    """Python objects (dicts, lists, tuples, str, bytes, int, float, None,
    bool, numpy arrays and scalars) -> one msgpack message, byte for byte
    as flax's msgpack_serialize writes a tree without chunked arrays."""
    enc = _Encoder()
    enc.encode(obj)
    return bytes(enc.out)


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


def _count(tree):
    return int(np.asarray(tree['count']))


def _chain(tx, opt_state):
    """The optimizer's own part of optax's state: behind the global-norm
    clip (an empty state '0') when GRAD_NORM_CLIP > 0."""
    if tx.max_norm > 0:
        if set(opt_state) != {'0', '1'} or opt_state['0']:
            raise ValueError('expected the clip_by_global_norm chain of '
                             'glenet_tpu/train/optim.py in opt_state')
        return opt_state['1']
    return opt_state


def _moments(net, tree):
    """A JAX params tree (an optimizer moment) -> tensors in the order of
    net.parameters(); every leaf consumed, every parameter set."""
    import torch

    from ..utils.jax_weights import jax_tree_to_port
    arrays = jax_tree_to_port(net, tree)
    params = dict(net.named_parameters())
    if set(arrays) != set(params):
        raise KeyError(f'optimizer moments and parameters differ: '
                       f'{sorted(set(arrays) ^ set(params))[:8]}')
    return [torch.from_numpy(arrays[k]).to(p.device, p.dtype)
            for k, p in params.items()]


def opt_state_from_jax(net, tx, opt_state):
    """optax's state of glenet_tpu/train/optim.py's chain (to_state_dict
    form, numpy leaves) -> the state of the port's optimizer `tx`
    (train/optim.py: AdamOneCycle, Adam or SGD) over net.parameters().
    The moments (`mu`, `nu`, `trace`) map by variable path with the weight
    bridge's layout rules.  Every count of the chain must agree: optax
    keeps inject_hyperparams' count and its schedules' beside
    scale_by_adam's, the port one count."""
    from . import optim
    inner = _chain(tx, opt_state)
    if isinstance(tx, optim.AdamOneCycle):
        adam = inner['inner_state']['0']
        counts = [_count(inner),
                  _count(adam)]
        counts += [_count(v) for v in
                   inner.get('hyperparams_states', {}).values()]
        hyper = inner['hyperparams']
        state = {'mu': _moments(net, adam['mu']),
                 'nu': _moments(net, adam['nu'])}
        if counts[0]:
            state['hyperparams'] = (float(hyper['learning_rate']),
                                    float(hyper['b1']))
    elif isinstance(tx, optim.Adam):
        adam = inner['0']
        counts = [_count(adam),
                  _count(inner['2'])]
        state = {'mu': _moments(net, adam['mu']),
                 'nu': _moments(net, adam['nu'])}
    elif isinstance(tx, optim.SGD):
        sgd = inner['1']
        counts = [_count(sgd['1'])]
        state = {'trace': _moments(net, sgd['0']['trace'])}
    else:
        raise NotImplementedError(f'optimizer {type(tx).__name__}')
    if len(set(counts)) != 1:
        raise ValueError(f'the counts of the optimizer state disagree: '
                         f'{counts}')
    return {'count': counts[0], **state}


def opt_state_to_jax(net, tx, state):
    """The inverse of opt_state_from_jax: the port optimizer's state ->
    optax's state of the same chain in to_state_dict form (numpy leaves,
    counts int32, hyperparameters float32)."""
    from ..utils.jax_weights import port_tree_to_jax
    from . import optim
    names = [k for k, _ in net.named_parameters()]

    def tree(tensors):
        return port_tree_to_jax(net, {k: t.detach().cpu().numpy()
                                      for k, t in zip(names, tensors)})

    count = np.asarray(state['count'], np.int32)
    if isinstance(tx, optim.AdamOneCycle):
        lr, b1 = state.get('hyperparams', tx.hyperparams(0))
        inner = {'count': count,
                 'hyperparams': {'b1': np.asarray(b1, np.float32),
                                 'learning_rate': np.asarray(lr,
                                                             np.float32)},
                 'hyperparams_states': {'b1': {'count': count},
                                        'learning_rate': {'count': count}},
                 'inner_state': {'0': {'count': count,
                                       'mu': tree(state['mu']),
                                       'nu': tree(state['nu'])},
                                 '1': {}, '2': {}}}
    elif isinstance(tx, optim.Adam):
        inner = {'0': {'count': count, 'mu': tree(state['mu']),
                       'nu': tree(state['nu'])},
                 '1': {}, '2': {'count': count}}
    elif isinstance(tx, optim.SGD):
        inner = {'0': {}, '1': {'0': {'trace': tree(state['trace'])},
                               '1': {'count': count}}}
    else:
        raise NotImplementedError(f'optimizer {type(tx).__name__}')
    return {'0': {}, '1': inner} if tx.max_norm > 0 else inner


def restore_train_state(train_state, ckpt, tx):
    """A loaded glenet_tpu checkpoint onto the port's TrainState in place:
    parameters and BN statistics, the optimizer state of `tx` and the
    step."""
    state = ckpt['state']
    load_variables(train_state.net, ckpt)
    train_state.opt_state = opt_state_from_jax(train_state.net, tx,
                                               state['opt_state'])
    train_state.step = int(np.asarray(state['step']))
    return train_state


def checkpoint_state(train_state, tx, epoch: int, it: int):
    """The port's TrainState as a glenet_tpu checkpoint dict ({epoch, it,
    state: {params, batch_stats, opt_state, step}}, JAX layouts)."""
    from ..utils.jax_weights import port_to_jax_variables
    variables = port_to_jax_variables(train_state.net)
    return {'epoch': epoch, 'it': it, 'state': {
        'params': variables['params'],
        'batch_stats': variables['batch_stats'],
        'opt_state': opt_state_to_jax(train_state.net, tx,
                                      train_state.opt_state),
        'step': np.asarray(train_state.step, np.int32)}}


def save_checkpoint(state_dict, ckpt_dir, epoch: int):
    """Write a checkpoint dict as <ckpt_dir>/checkpoint_epoch_<epoch>.msgpack
    (glenet_tpu's format); returns its path."""
    path = Path(ckpt_dir) / f'checkpoint_epoch_{epoch}.msgpack'
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(packb(state_dict))
    return str(path)


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
