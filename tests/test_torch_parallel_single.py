"""The port's data-parallel step on 2 gloo ranks x B = 1 against its own
one-process step on the B = 2 global batch, for the single-stage,
CenterHead and camera families (toy configs and batches of their parity
tests: GLENet-S, GLENet-C, SE-SSD with ATSS and MATCH_HEIGHT, 3-class
SECOND-multihead, PointPillars, CenterPoint and CaDDN), held as
test_torch_parallel_families.py holds the two-stage ones."""
import pytest

pytest.importorskip('jax')

import torch_dist as td  # noqa: E402
import torch_parity as tp  # noqa: E402


def _single(kind):
    cfg = tp.tiny_single_stage_cfg(kind)
    return cfg, tp.single_stage_batch(cfg)


def _sessd():
    from test_torch_sessd_atss import _cfg
    cfg = _cfg('sessd_atss_height')
    return cfg, tp.single_stage_batch(cfg)


def _centerpoint():
    from test_torch_centerpoint import center_batch, toy_cfg
    return toy_cfg(), center_batch()


def _caddn():
    import caddn_parity as cp
    return cp.toy_caddn_cfg(False), cp.toy_camera_batch(False)


CASES = {'GLENet-S': lambda: _single('S'), 'GLENet-C': lambda: _single('C'),
         'SE-SSD': _sessd, 'SECOND-multihead': lambda: _single('MULTIHEAD'),
         'PointPillars': lambda: _single('PILLAR'),
         'CenterPoint': _centerpoint, 'CaDDN': _caddn}


def case(name, make):
    from glenet_tpu.config import Cfg
    cfg, batch = make()
    if 'OPTIMIZATION' not in cfg:
        cfg.OPTIMIZATION = Cfg(dict(tp.TINY_OPTIMIZATION))
    tcfg = tp.to_port_cfg(cfg)
    return name, tcfg, td.jax_drawn_weights(cfg, tcfg, batch), batch


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    with tp.pinned_f32():
        cases = [case(n, m) for n, m in CASES.items()]
        return td.run_cases(cases, tmp_path_factory.mktemp('dp_single'))


@pytest.mark.parametrize('name', list(CASES))
def test_single_stage_family(runs, name):
    td.assert_family(name, *runs[name], two_stage=False)
