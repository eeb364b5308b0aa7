"""The port's reader of glenet_tpu checkpoints
(glenet_tpu_torch/train/jax_checkpoint.py, a msgpack decoder without flax)
against flax's msgpack_restore, on the CPU:

  - glenet_tpu.train.checkpoint.save_checkpoint writes a toy GLENet-VR
    checkpoint (random weights, an adam_onecycle state, a step); every leaf
    the port reads is bit-equal to flax's, with its dtype and shape;
  - the port's predict on it equals JAX's on the saved variables (final
    boxes and scores atol 1e-4, valid masks and labels equal), and the
    port's `tools.test --ckpt` evaluates the .msgpack;
  - hand-packed messages cover the formats a checkpoint does not hit: every
    int and float width, nil / bool, str / bin / array / map of each
    length class, fixext and ext 8/16/32, flax's complex, numpy-scalar and
    chunked arrays, bfloat16 (widened to float32), and malformed input."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import torch  # noqa: E402
from flax import serialization  # noqa: E402

import torch_parity as tp  # noqa: E402


def _assert_same(got, ref, where='root'):
    """Bit-equal trees: same keys, same types; arrays of the same dtype and
    shape and bytes."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), where
        for k in ref:
            _assert_same(got[k], ref[k], f'{where}/{k}')
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f'{where}[{i}]')
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref), where
        assert got.dtype == ref.dtype and got.shape == ref.shape, where
        assert got.tobytes() == ref.tobytes(), where
    else:
        assert type(got) is type(ref) and got == ref, where


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    from __graft_entry__ import _make_batch
    from glenet_tpu.models.detectors import build_detector
    from glenet_tpu.train import checkpoint as ckpt_lib
    from glenet_tpu.train import optim, state as state_lib
    from test_torch_train_cli import RANGE
    cfg = tp.tiny_twostage_cfg(512)
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(RANGE)   # the CLI test's grid
    batch = _make_batch(1, n_points=64,
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    det = build_detector(cfg)
    variables = tp.random_variables(
        jax.eval_shape(det.init, jax.random.PRNGKey(0), batch), seed=7)
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    params = jax.tree.map(jnp.asarray, variables['params'])
    ts = state_lib.TrainState(
        step=jnp.asarray(12, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables['batch_stats']),
        opt_state=tx.init(params))
    path = ckpt_lib.save_checkpoint(ckpt_lib.checkpoint_state(ts, 3, 12),
                                    tmp_path_factory.mktemp('jax_ckpt'), 3)
    return cfg, variables, path


def test_reader_bit_equal_to_flax(saved):
    from glenet_tpu_torch.train import jax_checkpoint
    _, variables, path = saved
    with open(path, 'rb') as f:
        ref = serialization.msgpack_restore(f.read())
    got = jax_checkpoint.load_checkpoint(path)
    _assert_same(got, ref)
    assert (got['epoch'], got['it']) == (3, 12)
    assert got['state']['step'].shape == () and int(got['state']['step']) == 12
    leaf = variables['params']['roi_head']['pool_x_conv2']['mlp_in']['kernel']
    np.testing.assert_array_equal(
        got['state']['params']['roi_head']['pool_x_conv2']['mlp_in']
        ['kernel'], leaf)


def test_predict_from_checkpoint(saved):
    from glenet_tpu_torch.train import jax_checkpoint
    cfg, variables, path = saved
    tdet = jax_checkpoint.build_detector_from_checkpoint(
        tp.to_port_cfg(cfg), path, device='cpu')
    with tp.pinned_f32():
        _, jax_pred, _, pred, _ = tp.run_predicts(cfg, variables=variables,
                                                  tdet=tdet)
    tp.assert_predict_equal(pred, jax_pred)


def test_test_cli_reads_msgpack(saved, tmp_path):
    """`tools.test --ckpt checkpoint_epoch_3.msgpack` loads the weights and
    evaluates, on a small synthetic tree."""
    from test_torch_train_cli import _write_cfg

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.models.detectors import Detector
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.utils import synthetic
    _, variables, path = saved
    root = synthetic.write_kitti_tree(
        tmp_path / 'kitti', n_train=2, n_val=2, seed=6, n_points=4000,
        cars=(2, 3), x_range=(6.0, 14.0), y_half=6.0, ground_radius=20.0)
    cfg_path = _write_cfg(tmp_path, root)
    cfg = cfg_from_yaml_file(str(cfg_path))
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    nets = []
    real = Detector.predict

    def predict(self, batch):
        nets.append(self.net)
        return real(self, batch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Detector, 'predict', predict)
        results = test_cli.main(['--cfg_file', str(cfg_path), '--ckpt',
                                 str(path), '--output_dir',
                                 str(tmp_path / 'out'), '--device', 'cpu'])
    (got_path, res), = results.items()
    assert got_path == str(path) and res['frames'] == 2
    assert (tmp_path / 'out' / 'eval' / 'epoch_3' / 'result.pkl').exists()
    bn = nets[0].backbone_3d.conv_input.MaskedBatchNorm_0.running_var
    np.testing.assert_array_equal(
        bn.numpy(), variables['batch_stats']['backbone_3d']['conv_input']
        ['MaskedBatchNorm_0']['var'])


def _hand_packed():
    """name -> msgpack bytes, each from msgpack or flax's own packers."""
    big = 70_000
    cases = {
        'ints': msgpack.packb([0, 127, -1, -32, -33, 128, 255, 256, 65535,
                               65536, 2**32 - 1, 2**32, 2**64 - 1, -128,
                               -129, -32768, -32769, -2**31, -2**31 - 1,
                               -2**63]),
        'float64': msgpack.packb([1.5, -2.25e300, 0.1]),
        'float32': msgpack.packb([1.5, 0.1], use_single_float=True),
        'nil_bool': msgpack.packb([None, True, False]),
        'str': msgpack.packb(['', 'a' * 31, 'b' * 32, 'c' * 255, 'd' * 256,
                              'e' * 65535, 'f' * 65536, 'gü€'],
                             use_bin_type=True),
        'bin': msgpack.packb([b'', b'x' * 255, b'y' * 256, b'z' * 65536],
                             use_bin_type=True),
        'arrays': msgpack.packb([list(range(15)), list(range(16)),
                                 list(range(big))]),
        'maps': msgpack.packb([{str(i): i for i in range(n)}
                               for n in (0, 15, 16, big)]),
        # fixext 4 (a complex whose inner message is 4 bytes), ext 8
        'fixext_complex': msgpack.packb(msgpack.ExtType(
            2, msgpack.packb((1, 200)))),
        'ext8_complex': msgpack.packb(msgpack.ExtType(
            2, msgpack.packb((1.5, -2.0)))),
    }
    rng = np.random.RandomState(0)
    cases['flax_arrays'] = serialization.msgpack_serialize({
        'f16': rng.randn(3, 2).astype(np.float16),
        'f64': rng.randn(5),
        'i8': np.arange(-5, 5, dtype=np.int8),
        'u64': np.arange(7, dtype=np.uint64) * (2**60),
        'bool': rng.rand(4, 4) > 0.5,
        'c64': (rng.randn(3) + 1j * rng.randn(3)).astype(np.complex64),
        'scalar_shape': np.asarray(3.5, np.float32),
        'empty': np.zeros((0, 3), np.float32),
        'ext16': rng.randn(100).astype(np.float32),
        'ext32': rng.randn(20_000).astype(np.float32),
        'np_scalars': {'f': np.float32(1.25), 'i': np.int64(-3),
                       'b': np.bool_(True)},
        'complex': 1.5 - 2j,
        'nested': {'list': [1, 'two', 3.0], 'none': None}})
    return cases


@pytest.mark.parametrize('name', ['ints', 'float64', 'float32', 'nil_bool',
                                  'str', 'bin', 'arrays', 'maps',
                                  'fixext_complex', 'ext8_complex',
                                  'flax_arrays'])
def test_hand_packed_messages(name):
    from glenet_tpu_torch.train import jax_checkpoint
    data = _hand_packed()[name]
    _assert_same(jax_checkpoint.msgpack_restore(data),
                 serialization.msgpack_restore(data))


def test_chunked_arrays(monkeypatch):
    """Arrays above flax's MAX_CHUNK_SIZE are stored in chunks and come
    back whole."""
    from glenet_tpu_torch.train import jax_checkpoint
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    tree = {'a': np.arange(100, dtype=np.float32).reshape(20, 5),
            'b': {'c': np.arange(40, dtype=np.int64)}}
    data = serialization.msgpack_serialize(tree)
    assert jax_checkpoint.CHUNKED.encode() in data
    _assert_same(jax_checkpoint.msgpack_restore(data),
                 serialization.msgpack_restore(data))
    _assert_same(jax_checkpoint.msgpack_restore(data), tree)


def test_bfloat16_widens_exactly():
    from glenet_tpu_torch.train import jax_checkpoint
    x = jnp.asarray(np.random.RandomState(1).randn(6, 3), jnp.bfloat16)
    got = jax_checkpoint.msgpack_restore(
        serialization.msgpack_serialize({'x': x}))['x']
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


@pytest.mark.parametrize('data,match', [
    (msgpack.packb(msgpack.ExtType(5, b'abc')), 'ext type 5'),
    (msgpack.packb([1, 2, 3])[:-1], 'truncated'),
    (b'\xc1', 'starts no msgpack object'),
    (msgpack.packb(1) + b'\x00', 'after the message')])
def test_malformed_messages_raise(data, match):
    from glenet_tpu_torch.train import jax_checkpoint
    with pytest.raises(ValueError, match=match):
        jax_checkpoint.msgpack_restore(data)


def test_port_reads_without_torch_tensors(saved):
    """The reader returns numpy arrays: a leaf goes into a port tensor
    through load_jax_variables unchanged."""
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train import jax_checkpoint
    cfg, variables, path = saved
    det = build_detector(tp.to_port_cfg(cfg), device='cpu')
    jax_checkpoint.load_variables(det.net, jax_checkpoint.load_checkpoint(
        path))
    w = det.net.dense_head.conv_cls.weight
    ref = variables['params']['dense_head']['conv_cls']['kernel']
    assert torch.equal(w, torch.from_numpy(ref.transpose(3, 2, 0, 1).copy()))
