"""The backward passes and train-mode pieces of the port's GLENet-VR train
step against glenet_tpu, module by module, numpy-drawn f32 inputs:

  - the submanifold gather-GEMM's gather-only backward (a
    torch.autograd.Function) against jax.vjp of the JAX custom VJP, on a toy
    grid, in f32 and with bf16 gathers; it builds no table (no merge-resolve
    call) in the backward;
  - the strided gather-GEMM's autograd and to_dense_expand's against
    jax.vjp of the JAX functions;
  - train-mode MaskedBatchNorm's gradient;
  - VoxelRCNNHead in train mode (DP_RATIO 0) against the JAX head: outputs
    and the BN running stats, std_bn0 / std_bn1 included;
  - dropout (port only): rate, 1 / (1 - p) scaling, none in eval;
  - adam_onecycle over 3 steps against glenet_tpu.train.optim;
  - the synthetic training batches (port only).

Tolerances: contractions and their gradients rtol 1e-5 / atol 1e-6 (f32 sums
in another order, as tests/test_torch_sparse.py); BN gradients rtol 1e-4 /
atol 1e-6; head outputs rtol 1e-4 / atol 1e-5 (~15 layers, as
tests/test_torch_detector.py); parameters after Adam rtol 1e-6 / atol 1e-7
(the schedules are f32 in JAX, f64 in the port)."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from glenet_tpu.models import layers as jl  # noqa: E402
from glenet_tpu.ops import sparse as jsp  # noqa: E402
from glenet_tpu.train import optim as joptim  # noqa: E402

from glenet_tpu_torch.models import layers as tl  # noqa: E402
from glenet_tpu_torch.models import roi_heads as trh  # noqa: E402
from glenet_tpu_torch.ops import merge_kernel as tmk  # noqa: E402
from glenet_tpu_torch.ops import sparse as tsp  # noqa: E402
from glenet_tpu_torch.train import optim as toptim  # noqa: E402

GRID = (10, 8, 6)
N_CELLS = 480
CIN, COUT = 4, 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=''):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=msg)


def _tables(seed, n_active=(40, 33), cap=64):
    rng = np.random.RandomState(seed)
    ids = np.full((2, cap), N_CELLS, np.int32)
    mask = np.zeros((2, cap), bool)
    for b, n in enumerate(n_active):
        ids[b, :n] = np.sort(rng.choice(N_CELLS, size=n, replace=False))
        mask[b, :n] = True
    feats = np.where(mask[..., None], rng.randn(2, cap, CIN), 0).astype(
        np.float32)
    w = (rng.randn(27, CIN, COUT) * 0.1).astype(np.float32)
    g = rng.randn(2, cap, COUT).astype(np.float32)
    return ids, mask, feats, w, g


def test_flip_tap_weights():
    w = np.random.RandomState(0).randn(27, CIN, COUT).astype(np.float32)
    np.testing.assert_array_equal(tsp.flip_tap_weights(_t(w)).numpy(),
                                  np.asarray(jsp.flip_tap_weights(w)))


@pytest.mark.parametrize('seed', [0, 1])
def test_subm_gather_gemm_backward(seed, monkeypatch):
    ids, mask, feats, w, g = _tables(seed)
    with tp.pinned_f32():
        @jax.jit
        def ref(ids_, mask_, feats_, w_, g_):
            q_j, tbl_j = jsp.subm_xblock_table_b(ids_, mask_, GRID)
            out_j, vjp = jax.vjp(lambda f, ww: jsp.subm_gather_gemm_xblocks_b(
                f, q_j, tbl_j, ww), feats_, w_)
            return (out_j, *vjp(g_))

        out_j, df_j, dw_j = ref(ids, mask, feats, w, g)
        q, tbl = tsp.subm_xblock_table_b(_t(ids), _t(mask), GRID)
        f_t, w_t = _t(feats).requires_grad_(), _t(w).requires_grad_()
        out = tsp.subm_gather_gemm_xblocks_b(f_t, q, tbl, w_t)
        calls = []
        real = tmk.resolve_sorted_queries
        monkeypatch.setattr(tmk, 'resolve_sorted_queries',
                            lambda *a: calls.append(1) or real(*a))
        out.backward(_t(g))
        assert not calls, 'the backward resolved queries (built a table)'
        # autograd of the plain contraction (scatter-add) agrees too
        f2, w2 = _t(feats).requires_grad_(), _t(w).requires_grad_()
        tsp.gather_gemm_xblocks_b(f2, q, tbl, w2).backward(_t(g))
    _close(out, out_j)
    _close(f_t.grad, df_j, msg='d_features')
    _close(w_t.grad, dw_j, msg='d_weights')
    _close(f_t.grad, f2.grad.numpy())
    _close(w_t.grad, w2.grad.numpy())


@pytest.mark.parametrize('seed', [0, 1])
def test_subm_gather_gemm_bf16(seed, monkeypatch):
    """With bf16 gathers on both sides (the card's default), the forward and
    both gradients are f32 contractions of bf16-rounded operands, as the JAX
    custom VJP's preferred_element_type=float32: bf16 products are exact in
    f32, so only the summation order differs (rtol 1e-5, atol 1e-5 of the
    largest value).  A bf16-rounded result would be ~4e-3 off."""
    ids, mask, feats, w, g = _tables(seed)
    monkeypatch.setattr(jsp, 'GATHER_COMPUTE_DTYPE', jnp.bfloat16)
    monkeypatch.setattr(tsp, 'GATHER_COMPUTE_DTYPE', torch.bfloat16)
    q_j, tbl_j = jsp.subm_xblock_table_b(ids, mask, GRID)
    out_j, vjp = jax.vjp(lambda f, ww: jsp.subm_gather_gemm_xblocks_b(
        f, q_j, tbl_j, ww), feats, w)
    df_j, dw_j = vjp(g)
    q, tbl = tsp.subm_xblock_table_b(_t(ids), _t(mask), GRID)
    f_t, w_t = _t(feats).requires_grad_(), _t(w).requires_grad_()
    out = tsp.subm_gather_gemm_xblocks_b(f_t, q, tbl, w_t)
    out.backward(_t(g))
    for got, ref, name in ((out, out_j, 'out'), (f_t.grad, df_j, 'd_features'),
                           (w_t.grad, dw_j, 'd_weights')):
        assert got.dtype == torch.float32
        ref = np.asarray(ref)
        _close(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(), msg=name)


def test_strided_gather_gemm_backward():
    ids, mask, feats, w, _ = _tables(2)
    oi, om = jax.jit(jax.vmap(lambda i, m: jsp.strided_output_sites(
        i, m, GRID, 3, 2, 1, 48)))(ids, mask)
    oi, om = np.array(oi), np.array(om)
    g = np.random.RandomState(3).randn(2, 48, COUT).astype(np.float32)
    with tp.pinned_f32():
        @jax.jit
        def ref(feats_, w_, g_):
            q_j, tbl_j = jsp.strided_xblock_table_b(ids, mask, oi, om, GRID,
                                                    2, 1)
            _, vjp = jax.vjp(lambda f, ww: jsp.gather_gemm_xblocks_b(
                f, q_j, tbl_j, ww), feats_, w_)
            return vjp(g_)

        df_j, dw_j = ref(feats, w, g)
        q, tbl = tsp.strided_xblock_table_b(_t(ids), _t(mask), _t(oi),
                                            _t(om), GRID, 2, 1)
        f_t, w_t = _t(feats).requires_grad_(), _t(w).requires_grad_()
        tsp.gather_gemm_xblocks_b(f_t, q, tbl, w_t).backward(_t(g))
    _close(f_t.grad, df_j)
    _close(w_t.grad, dw_j)


def test_to_dense_expand_backward():
    """A gather of the canvas gradient at each row's cell, zero at masked
    rows."""
    ids, mask, feats, _, _ = _tables(4)
    nx, ny, nz = GRID
    g = np.random.RandomState(5).randn(2, nz, ny, nx, CIN).astype(np.float32)
    (dense_j, _), vjp = jax.vjp(
        lambda f: jsp.to_dense_expand(f, ids, mask, GRID), feats)
    df_j, = vjp((g, np.zeros(dense_j.shape[:-1], jax.dtypes.float0)))
    f_t = _t(feats).requires_grad_()
    dense, _ = tsp.to_dense_expand(f_t, _t(ids), _t(mask), GRID)
    dense.backward(_t(g))
    np.testing.assert_array_equal(f_t.grad.numpy(), np.asarray(df_j))
    assert not f_t.grad.numpy()[~mask].any()


def test_masked_batchnorm_train_gradient():
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 17, 5) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(3, 17) > 0.3
    params = {'scale': rng.uniform(0.5, 1.5, 5).astype(np.float32),
              'bias': (rng.randn(5) * 0.1).astype(np.float32)}
    stats = {'mean': np.zeros(5, np.float32), 'var': np.ones(5, np.float32)}
    g = rng.randn(3, 17, 5).astype(np.float32)

    def jax_fn(x_, p):
        y, _ = jl.MaskedBatchNorm(eps=1e-3).apply(
            {'params': p, 'batch_stats': stats}, x_, mask=mask,
            use_running_average=False, mutable=['batch_stats'])
        return jnp.sum(y * g)

    dx_j, dp_j = jax.grad(jax_fn, argnums=(0, 1))(x, params)
    bn = tl.MaskedBatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(_t(params['scale']))
        bn.bias.copy_(_t(params['bias']))
    x_t = _t(x).requires_grad_()
    (bn(x_t, mask=_t(mask), use_running_average=False) * _t(g)).sum(
        ).backward()
    _close(x_t.grad, dx_j, rtol=1e-4)
    _close(bn.weight.grad, dp_j['scale'], rtol=1e-4)
    _close(bn.bias.grad, dp_j['bias'], rtol=1e-4)


# ---------------------------------------------------------------------------
# the RoI head in train mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def head_runs():
    from __graft_entry__ import _make_batch
    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.ops import voxelize as jvox

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import (jax_tree_to_port,
                                                    load_jax_variables)
    cfg = tp.tiny_twostage_cfg(512)
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    batch = _make_batch(2, n_points=1024, seed=3,
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    rng = np.random.RandomState(9)
    rois = np.zeros((2, 8, 7), np.float32)
    rois[..., :2] = rng.uniform([2, -6], [14, 6], (2, 8, 2))
    rois[..., 2] = rng.uniform(-0.6, 0.2, (2, 8))
    rois[..., 3:6] = rng.uniform([3.2, 1.4, 1.3], [4.6, 1.9, 1.8], (2, 8, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (2, 8))
    with tp.pinned_f32():
        det = jax_build(cfg)
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0), batch)
        variables = tp.random_variables(shapes, seed=1)

        def head(m, points, pmask, rois_):
            vox = jax.vmap(functools.partial(
                jvox.voxelize, voxel_size=det.voxel_size,
                pc_range=det.pc_range, grid_size=det.grid_size,
                max_voxels=det.max_voxels,
                max_points_per_voxel=det.max_points_per_voxel))(points, pmask)
            feats = jax.vmap(lambda v, n: m.vfe(v, n, train=False))(
                vox['voxels'], vox['voxel_num_points'])
            sp = m.backbone_3d(feats, vox['voxel_coords'], vox['voxel_mask'],
                               train=False)
            return m.roi_head(rois_, sp['multi_scale'], train=True)

        out_j, new = jax.jit(lambda v, p, pm, r: det.net.apply(
            v, p, pm, r, method=head, mutable=['batch_stats']))(
            variables, batch['points'], batch['points_mask'], rois)
        tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
        load_jax_variables(tdet.net, variables)
        net = tdet.net
        pts = _t(batch['points'])
        pmask = _t(batch['points_mask'])
        with torch.no_grad():
            vox = net.voxelize(pts, pmask, tdet.max_voxels_train)
            sp = net.backbone_3d(net.vfe(vox['voxels'],
                                         vox['voxel_num_points']),
                                 vox['voxel_coords'], vox['voxel_mask'])
            out = net.roi_head(_t(rois), sp['multi_scale'], train=True)
    stats = jax_tree_to_port(net, {'roi_head': jax.tree.map(
        np.asarray, new['batch_stats']['roi_head'])}, 'batch_stats')
    return out_j, out, stats, dict(net.named_buffers()), variables


def test_roi_head_train_mode(head_runs):
    out_j, out, _, _, _ = head_runs
    for k in ('rcnn_cls', 'rcnn_reg', 'rcnn_reg_std'):
        _close(out[k], out_j[k], rtol=1e-4, atol=1e-5, msg=k)


def test_roi_head_train_mode_bn_stats(head_runs):
    """Every BN of the head takes batch moments in train mode and updates
    its running stats, the variance -> confidence branch's std_bn0 and
    std_bn1 included."""
    _, _, stats, buffers, variables = head_runs
    assert 'roi_head.std_bn0.running_mean' in stats
    assert 'roi_head.std_bn1.running_var' in stats
    old = variables['batch_stats']['roi_head']
    for k, v in stats.items():
        _close(buffers[k], v, rtol=1e-4, atol=1e-5, msg=k)
    assert not np.array_equal(buffers['roi_head.std_bn0.running_mean'],
                              old['std_bn0']['mean'])


def test_dropout():
    """Inverted dropout: drops a share p of the entries, scales the rest by
    1 / (1 - p), and one generator state gives one mask."""
    x = torch.rand(200_000) + 0.5
    p = 0.3
    y = trh.dropout(x, p, torch.Generator().manual_seed(0))
    dropped = y == 0
    assert abs(float(dropped.float().mean()) - p) < 0.005
    torch.testing.assert_close(y[~dropped], x[~dropped] / (1 - p),
                               rtol=0, atol=0)
    assert torch.equal(y, trh.dropout(x, p, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, trh.dropout(x, p,
                                          torch.Generator().manual_seed(1)))


def test_head_dropout_only_in_train():
    """DP_RATIO drops after the first FC of each stack in train mode and
    nowhere in eval mode."""
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.synthetic import seeded_detector
    cfg = tp.to_port_cfg(tp.tiny_twostage_cfg(512))
    det = seeded_detector(cfg, 'cpu', 0)
    head = det.net.roi_head
    assert head.dp_ratio == 0.3
    feats = torch.rand(24, head.shared_0.in_features)
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    plain = build_detector(cfg, device='cpu').net.roi_head
    plain.load_state_dict(head.state_dict())
    runs = {}
    for train in (False, True):
        for seed in (0, 1):
            with torch.no_grad():
                runs[train, seed] = head._fc_stack(
                    feats, 'shared', train, torch.Generator().manual_seed(seed))
    assert torch.equal(runs[False, 0], runs[False, 1])
    assert not torch.equal(runs[True, 0], runs[True, 1])
    with torch.no_grad():
        assert torch.equal(plain._fc_stack(feats, 'shared', False, None),
                           runs[False, 0])


# ---------------------------------------------------------------------------
# adam_onecycle
# ---------------------------------------------------------------------------

def test_adam_onecycle_three_steps():
    """Clip (step 1's gradients are above GRAD_NORM_CLIP), Adam with the
    step's b1, decoupled decay and the LR, across the one-cycle split
    (total_steps 5: split at step 2)."""
    import optax
    cfg = tp.tiny_twostage_cfg()
    opt_cfg = tp.to_port_cfg(cfg).OPTIMIZATION
    total = 5
    tx_j, lr_j = joptim.build_optimizer(cfg.OPTIMIZATION, total)
    tx_t, lr_t = toptim.build_optimizer(opt_cfg, total)
    for step in range(total + 2):
        np.testing.assert_allclose(lr_t(step), float(lr_j(step)), rtol=1e-6)
    rng = np.random.RandomState(7)
    params = {'a': rng.randn(5, 4).astype(np.float32),
              'b': rng.randn(3).astype(np.float32)}
    p_t = [_t(params['a']), _t(params['b'])]
    state_j, state_t = tx_j.init(params), tx_t.init(p_t)
    for step in range(3):
        scale = 100.0 if step == 1 else 1.0
        grads = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        upd, state_j = tx_j.update(grads, state_j, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
        norm = tx_t.update(p_t, [_t(grads['a']), _t(grads['b'])], state_t)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-6)
        assert (float(norm) > float(cfg.OPTIMIZATION.GRAD_NORM_CLIP)) == (
            step == 1)
        _close(p_t[0], params['a'], rtol=1e-6, atol=1e-7)
        _close(p_t[1], params['b'], rtol=1e-6, atol=1e-7)
    assert state_t['count'] == 3


def test_optimizer_refuses_others():
    cfg = tp.to_port_cfg(tp.tiny_twostage_cfg()).OPTIMIZATION
    cfg.OPTIMIZER = 'adam_cosine'
    with pytest.raises(NotImplementedError):
        toptim.build_optimizer(cfg, 10)


# ---------------------------------------------------------------------------
# synthetic training batches
# ---------------------------------------------------------------------------

def test_train_batches():
    from glenet_tpu_torch.utils import synthetic
    a = synthetic.train_batches(2, seed=4, batch=2, device='cpu',
                                n_points=4096)
    b = synthetic.train_batches(2, seed=4, batch=2, device='cpu',
                                n_points=4096)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k])
    bt = a[0]
    m = synthetic.MAX_GT_PER_SCENE
    assert bt['gt_boxes'].shape == (2, m, 8)
    assert bt['gt_uncertainty'].shape == (2, m, 7)
    assert bt['points'].shape == (2, 4096, 4)
    gm = bt['gt_mask']
    assert gm.any(1).all() and not gm.all()
    assert (bt['gt_uncertainty'][gm] > 0).all()
    assert (bt['gt_boxes'][..., 7][gm] == 1).all()
    assert not bt['gt_boxes'][~gm].any()
    # each gt sits on points of its cluster
    pts = bt['points'][0, :, :2]
    for box in bt['gt_boxes'][0][gm[0]]:
        near = ((pts - box[:2]).abs() < torch.tensor([2.0, 1.0])).all(1)
        assert near.sum() > 20
