"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
set of numpy-drawn weights and inputs goes through glenet_tpu and through
glenet_tpu_torch, both pinned to float32."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest


def to_port_cfg(cfg):
    """A glenet_tpu Cfg -> the port's own Cfg (plain nested dicts)."""
    import json

    from glenet_tpu_torch.config import Cfg
    return Cfg(json.loads(json.dumps(cfg)))


def tiny_twostage_cfg(max_voxels=512):
    """The repo's toy GLENet-VR topology with GLENet-VR's dense head."""
    from __graft_entry__ import _tiny_twostage_cfg
    cfg = _tiny_twostage_cfg(max_voxels)
    cfg.MODEL.DENSE_HEAD.NAME = 'AnchorHeadSingle'
    return cfg


def random_variables(shapes, seed):
    """Numpy draws for every leaf of a JAX variables tree (a tree of arrays
    or ShapeDtypeStructs): kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1),
    BN scale / var ~ U(0.5, 1.5), BN mean ~ N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def draw(tree, leafname=None):
        if hasattr(tree, 'items'):
            return {k: draw(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        if leafname == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif leafname in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, shape)
        else:                                    # bias, mean
            v = rng.randn(*shape) * 0.1
        return v.astype(np.float32)

    return draw(shapes)


@contextlib.contextmanager
def pinned_f32():
    """Both packages' gather and dense-level compute dtypes set to f32."""
    from glenet_tpu.models import spconv_backbone as jbb
    from glenet_tpu.ops import sparse as jsp

    from glenet_tpu_torch.models import spconv_backbone as tbb
    from glenet_tpu_torch.ops import sparse as tsp
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jsp, 'GATHER_COMPUTE_DTYPE'),
                          (jbb, 'DENSE_MXU_DTYPE'),
                          (tsp, 'GATHER_COMPUTE_DTYPE'),
                          (tbb, 'DENSE_MXU_DTYPE')):
            mp.setattr(mod, name, None)
        yield
