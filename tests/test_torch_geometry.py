"""The port's geometry helpers, box coder, anchors and configs against
glenet_tpu's: same inputs, f32 (atol 1e-5 for trigonometry in another
library; anchors and configs exact)."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from glenet_tpu import config as jcfg  # noqa: E402
from glenet_tpu.models import anchors as janchors  # noqa: E402
from glenet_tpu.utils import box_coder as jcoder  # noqa: E402
from glenet_tpu.utils import box_utils as jbox  # noqa: E402
from glenet_tpu.utils import common as jcommon  # noqa: E402

from glenet_tpu_torch import config as tcfg  # noqa: E402
from glenet_tpu_torch.models import anchors as tanchors  # noqa: E402
from glenet_tpu_torch.utils import box_coder as tcoder  # noqa: E402
from glenet_tpu_torch.utils import box_utils as tbox  # noqa: E402
from glenet_tpu_torch.utils import common as tcommon  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(ROOT)) for d in ('kitti_models',
                                                     'dataset_configs')
                 for p in (ROOT / 'configs' / d).glob('*.yaml'))


def _boxes(seed, n=50):
    r = np.random.RandomState(seed)
    b = r.randn(n, 7).astype(np.float32) * 3
    b[:, 3:6] = np.abs(b[:, 3:6]) + 0.5
    return b


def _close(got, ref, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


def test_common_and_corners():
    b = _boxes(0)
    tb = torch.from_numpy(b)
    _close(tcommon.limit_period(tb[:, 6] * 4, 0.5, 2 * np.pi),
           jcommon.limit_period(b[:, 6] * 4, 0.5, 2 * np.pi))
    pts = np.random.RandomState(1).randn(4, 9, 5).astype(np.float32)
    ang = b[:4, 6]
    _close(tcommon.rotate_points_along_z(torch.from_numpy(pts),
                                         torch.from_numpy(ang)),
           jcommon.rotate_points_along_z(pts, ang))
    _close(tcommon.rotate_points_along_z(torch.from_numpy(pts[0]), 0.3),
           jcommon.rotate_points_along_z(pts[0], 0.3))
    _close(tbox.boxes_to_corners_3d(tb), jbox.boxes_to_corners_3d(b))
    _close(tbox.corners_bev(tb), jbox.corners_bev(b))


def test_residual_coder_decode():
    enc = _boxes(2) * 0.1
    anchors = _boxes(3)
    ref = jcoder.ResidualCoder().decode(enc, anchors)
    got = tcoder.ResidualCoder().decode(torch.from_numpy(enc),
                                        torch.from_numpy(anchors))
    _close(got, ref, atol=1e-4)
    # PointResidualCoder is ported (tests/test_torch_parta2.py holds it),
    # and the legacy decoder decodes as JAX's does
    assert isinstance(tcoder.build_box_coder('PointResidualCoder'),
                      tcoder.PointResidualCoder)
    prev = tcoder.build_box_coder('PreviousResidualDecoder')
    ref = jcoder.PreviousResidualDecoder().decode(enc, anchors)
    got = prev.decode(torch.from_numpy(enc), torch.from_numpy(anchors))
    _close(got, ref, atol=1e-4)


def test_anchors():
    cfg = tp.tiny_twostage_cfg().MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG
    args = (cfg, (1408, 1600, 40), (0, -40, -3, 70.4, 40, 1))
    ref = janchors.generate_anchors(*args)
    got = tanchors.generate_anchors(*args)
    np.testing.assert_array_equal(got.flat_anchors, ref.flat_anchors)
    assert got.num_anchors_per_location == ref.num_anchors_per_location


@pytest.mark.parametrize('path', CONFIGS)
def test_config_matches(path, monkeypatch):
    """Every KITTI model and dataset config reads the same in both
    packages, `_BASE_CONFIG_` included; typed overrides agree."""
    monkeypatch.chdir(ROOT)
    ref = jcfg.cfg_from_yaml_file(path)
    got = tcfg.cfg_from_yaml_file(path)
    assert got == ref
    if 'MODEL' in ref:
        sets = ['MODEL.NAME', 'Other', 'OPTIMIZATION.LR', '0.5']
        if 'DATA_CONFIG' in ref:
            sets += ['DATA_CONFIG.POINT_CLOUD_RANGE', '0,-1,-2,3,4,5']
        jcfg.cfg_from_list(sets, ref)
        tcfg.cfg_from_list(sets, got)
        assert got == ref and got.OPTIMIZATION.LR == 0.5
    with pytest.raises(KeyError):
        tcfg.cfg_from_list(['NO_SUCH_KEY.X', '1'], got)
