"""Guards of the port: glenet_tpu_torch and chip_smoke.py import neither
JAX nor glenet_tpu, and the port never quietly defaults to the CPU."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip('jax')

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import glenet_tpu_torch
for m in pkgutil.walk_packages(glenet_tpu_torch.__path__, 'glenet_tpu_torch.'):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'glenet_tpu'))
print('BAD', bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, '-c', _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert 'BAD []' in out.stdout, out.stdout


def test_build_detector_needs_a_device():
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector

    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    if torch.cuda.is_available():
        assert build_detector(cfg).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_detector(cfg)


def test_other_families_raise():
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector

    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/second.yaml'))
    with pytest.raises(NotImplementedError):
        build_detector(cfg, device='cpu')


@pytest.mark.parametrize('section,key,value', [
    ('DENSE_HEAD.TARGET_ASSIGNER_CONFIG', 'MATCH_HEIGHT', True),
    ('ROI_HEAD.TARGET_CONFIG', 'CLS_SCORE_TYPE', 'cls')])
def test_unported_options_raise(section, key, value):
    """Options of the ported modules that no GLENet-VR config sets are
    refused, not computed some other way."""
    import torch_parity as tp

    from glenet_tpu_torch.models.detectors import build_detector

    cfg = tp.to_port_cfg(tp.tiny_twostage_cfg())
    node = cfg.MODEL
    for part in section.split('.'):
        node = node[part]
    node[key] = value
    with pytest.raises(NotImplementedError, match=key):
        build_detector(cfg, device='cpu')


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises."""
    from glenet_tpu_torch.ops import merge_kernel as mk

    ids = torch.zeros((1, 8), dtype=torch.int32, device='meta')
    q = torch.zeros((1, 1, 4), dtype=torch.int32, device='meta')
    monkeypatch.setattr(mk, 'resolve_sorted_queries_plain',
                        lambda *a: pytest.fail('fell back to the plain path'))
    with pytest.raises(ValueError, match='unsupported device'):
        mk.resolve_sorted_queries(ids, q)
