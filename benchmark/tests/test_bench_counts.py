"""The yardstick's arithmetic: idle share of overlapping kernels, the FLOP
counter's site pairs, the merge-resolve bytes."""
import itertools
import types

import pytest
import torch

from benchmark import flops, tracing
from benchmark.reference import common


def test_union_of_overlapping_intervals():
    assert tracing.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert tracing.union_length([(0, 10), (2, 3)]) == 10
    assert tracing.union_length([]) == 0


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


def _event(name, start, end, device):
    return types.SimpleNamespace(
        name=name, time_range=_Range(start, end),
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU))


def test_idle_share_counts_overlap_once():
    events = [_event(tracing.WINDOW_RANGE, 0, 100, False),
              _event(tracing.WINDOW_RANGE, 5, 120, True),
              _event('host_op', 10, 60, False),
              _event(tracing.MERGE_RANGE, 12, 18, False),
              _event(tracing.MERGE_RANGE, 20, 35, True),
              _event('k1', 20, 50, True), _event('k2', 30, 40, True),
              _event('k3', 90, 120, True)]
    out = tracing.analyse(events)
    assert out['window_s'] == pytest.approx(100e-6)
    assert out['busy_s'] == pytest.approx(40e-6)
    assert out['merge_device_s'] == pytest.approx(15e-6)
    gaps = dict(out['idle_gaps'])
    assert gaps['host_op'] == pytest.approx(20e-6)      # 0-20: host_op at 10
    assert gaps['no host op'] == pytest.approx(40e-6)   # 50-90
    assert dict(out['device_ops'])['k3'] == pytest.approx(10e-6)


def _brute_pairs(coords, grid):
    active = {tuple(c) for c in coords}
    n = 0
    for z, y, x in active:
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            n += (z + dz, y + dy, x + dx) in active
    return n


def _brute_strided(coords, out_coords):
    active = {tuple(c) for c in coords}
    n = 0
    for oz, oy, ox in out_coords:
        for kz, ky, kx in itertools.product(range(3), repeat=3):
            n += (2 * oz - 1 + kz, 2 * oy - 1 + ky, 2 * ox - 1 + kx) in active
    return n


def test_sparse_pairs_against_brute_force():
    g = torch.Generator().manual_seed(0)
    grid = (9, 7, 5)
    ids = torch.unique(torch.randint(0, 9 * 7 * 5, (120,), generator=g))
    lvl = common.Level(ids, torch.zeros_like(ids), grid)
    coords = lvl.coords.tolist()
    assert flops._hits(common.subm_table(lvl), len(lvl)) == _brute_pairs(
        coords, grid)
    nxt = common.strided_sites(lvl, 1, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    t = common.gather_table(lvl, nxt, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    r = common.reverse_table(lvl, nxt, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    assert flops._hits(r, len(nxt)) == flops._hits(t, len(lvl))
    assert flops._hits(t, len(lvl)) == _brute_strided(coords,
                                                      nxt.coords.tolist())
    # every active site of the strided level covers an active input
    assert (t < len(lvl)).any(1).all()


@pytest.mark.parametrize('kernel,stride,pad', [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)), ((3, 1, 1), (2, 1, 1), (0, 0, 0))])
def test_sparse_conv_matches_dense_conv(kernel, stride, pad):
    """The gathered conv and its gather-only backward equal a dense conv
    (and its autograd) at the active sites."""
    g = torch.Generator().manual_seed(1)
    occ = torch.rand((1, 5, 7, 9), generator=g) < 0.3
    ids = torch.nonzero(occ[0].reshape(-1)).squeeze(1)
    src = common.Level(ids, torch.zeros_like(ids), (9, 7, 5))
    if stride == (1, 1, 1):
        out = src
    else:
        out = common.strided_sites(src, 1, kernel, stride, pad)
    x = torch.randn(len(src), 3, generator=g, requires_grad=True)
    w = torch.randn(4, 3, *kernel, generator=g, requires_grad=True)
    cot = torch.randn(len(out), 4, generator=g)
    y = common.sparse_conv(x, common.conv_tables(src, out, kernel, stride,
                                                 pad),
                           common.kernel_of({'backbone_3d.c.weight': w}, 'c'),
                           common.Precision('f32'))
    gx, gw = torch.autograd.grad((y * cot).sum(), [x, w])
    dense = torch.nn.functional.conv3d(common.densify(x, src, 1), w,
                                       stride=stride, padding=pad)
    want = dense[0].permute(1, 2, 3, 0).reshape(-1, 4)[out.ids]
    assert torch.allclose(y, want, atol=1e-5)
    hx, hw = torch.autograd.grad((want * cot).sum(), [x, w])
    assert torch.allclose(gx, hx, atol=1e-5)
    assert torch.allclose(gw, hw, atol=1e-4)


def test_decimation_keeps_cap_sites_evenly():
    ids = torch.arange(0, 1000, 3)
    kept = common.decimate(ids, 100)
    assert len(kept) == 100 and kept[0] == 0
    assert common.decimate(ids, 1000).equal(ids)


def test_merge_contract_bytes():
    # a Waymo train call: ids (4, 264000), queries (4, 9, 304000)
    b = tracing.contract_bytes((4, 264000), (4, 9, 304000))
    assert b == 4 * 4 * 264000 + 4 * 4 * 9 * 304000 * 5
    # PERF's Waymo train bound: the 4 calls' bytes over 3.35 TB/s
    calls = [((4, 80000), (4, 9, 80000)), ((4, 80000), (4, 9, 264000)),
             ((4, 264000), (4, 9, 264000)), ((4, 264000), (4, 9, 304000))]
    total = sum(tracing.contract_bytes(*c) for c in calls)
    assert total / 3.35e12 * 1e3 == pytest.approx(0.1993, abs=2e-4)
