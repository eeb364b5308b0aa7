"""CaDDN's camera modules in the port (glenet_tpu_torch/models/image_vfe.py)
against glenet_tpu's on the CPU, the same numpy inputs and weights:
bin_depths, voxel_grid_centers, the trilinear frustum sampling (forward
and backward, f32 and bf16 gathers, chunk counts that do and do not divide
N), DDNLite, ImageVFE, Conv2DCollapse and ddn_loss.

Tolerances:
  - f32 arithmetic done in the same order: 1e-6 relative (XLA may contract
    a product and a sum into one FMA);
  - the bf16 gather of the same f32 volume rounds each value alike, so
    its forward is held as the f32 one;
  - ImageVFE's frustum is computed by each package's convolutions, so a
    frustum value within f32 rounding of a bf16 rounding boundary may round
    the other way: one bf16 ulp of that value (bf16 keeps 8 significant
    bits, so an ulp is at most 2^-7 of the value, twice the 2^-8 of a
    rounding), times its trilinear weight, per voxel feature;
  - the sampler's backward: glenet_tpu sums the volume's cotangent in
    bf16 (each corner's g * w rounded, then every add), the port in f32.
    Per volume cell with n contributions c_i that rounding is within
    (n + 1) 2^-8 sum |c_i| (2^-8: bf16's unit roundoff); the port's f32
    sums are held to that bound (derived, not fitted), and
    tests/caddn_parity.py's numpy model of the bf16 order is held
    bit-equal to jax.vjp;
  - SID bins: XLA's and torch's f32 log may differ in the last bit, which
    the bin scale (num_bins over the log range) magnifies.
"""
import numpy as np
import pytest

pytest.importorskip('jax')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import caddn_parity as cp  # noqa: E402
import torch_parity as tp  # noqa: E402

BF16_EPS = 2.0 ** -8     # bf16's unit roundoff: a rounding's relative error
BF16_ULP = 2.0 ** -7     # the largest spacing of bf16 values, relative


@pytest.mark.parametrize('mode', ['UD', 'LID', 'SID'])
def test_bin_depths(mode):
    from glenet_tpu.models import image_vfe as jiv

    from glenet_tpu_torch.models import image_vfe as tiv
    rng = np.random.RandomState(0)
    depth = np.concatenate([
        rng.uniform(0.0, 60.0, 5000), [0.0, -1.0, 2.0, 46.8, 47.0, 1e4,
                                       np.inf, np.nan]]).astype(np.float32)
    args = (mode, 2.0, 46.8, 80)
    cont = np.asarray(jiv.bin_depths(jnp.asarray(depth), *args))
    got = tiv.bin_depths(torch.from_numpy(depth), *args).numpy()
    finite = np.isfinite(cont)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    tol = 1e-6 * np.abs(cont[finite]) + 1e-6
    if mode == 'SID':
        # 2 ulp of log(1 + d), times the bin scale
        tol = tol + 80 * 2 * 2.0 ** -23 * np.log1p(np.abs(depth[finite])) \
            / (np.log(47.8) - np.log(3.0))
    assert np.all(np.abs(got[finite] - cont[finite]) <= tol)
    tgt = np.asarray(jiv.bin_depths(jnp.asarray(depth), *args, target=True))
    got_t = tiv.bin_depths(torch.from_numpy(depth), *args,
                           target=True).numpy()
    np.testing.assert_array_equal(got_t, tgt)
    assert got_t.min() >= 0 and got_t.max() == 80


def test_voxel_grid_centers():
    from glenet_tpu.models import image_vfe as jiv

    from glenet_tpu_torch.models import image_vfe as tiv
    args = ((280, 376, 25), (2, -30.08, -3.0, 46.8, 30.08, 1.0))
    np.testing.assert_array_equal(tiv.voxel_grid_centers(*args),
                                  jiv.voxel_grid_centers(*args))


def _volume_case(n=203, shape=(12, 8, 12, 16), seed=0):
    rng = np.random.RandomState(seed)
    vol = rng.randn(*shape).astype(np.float32)
    d, h, w = shape[:3]
    coords = np.stack([rng.uniform(-1.5, d + 0.5, n),
                       rng.uniform(-1.5, h + 0.5, n),
                       rng.uniform(-1.5, w + 0.5, n)], 1).astype(np.float32)
    coords[:3] = [[1, 2, 3], [0, 0, 0], [d - 1, h - 1, w - 1]]   # lattice
    coords[3] = [-2.0, 1.0, 1.0]                                 # outside
    return vol, coords


def _oracle(vol, coords):
    """float64 trilinear interpolation with zero padding, and per corner
    the (flat row, weight) pairs."""
    d, h, w, c = vol.shape
    out = np.zeros((len(coords), c))
    pairs = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                z = np.floor(coords[:, 0]) + dz
                y = np.floor(coords[:, 1]) + dy
                x = np.floor(coords[:, 2]) + dx
                wgt = ((1 - np.abs(coords[:, 0] - z))
                       * (1 - np.abs(coords[:, 1] - y))
                       * (1 - np.abs(coords[:, 2] - x)))
                inb = ((z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0)
                       & (x < w))
                zi, yi, xi = (np.where(inb, t, 0).astype(int)
                              for t in (z, y, x))
                out += np.where(inb, wgt, 0)[:, None] * vol[zi, yi, xi]
                pairs.append((np.where(inb, (zi * h + yi) * w + xi, -1),
                              np.where(inb, wgt, 0.0)))
    return out, pairs


@pytest.mark.parametrize('gather', ['f32', 'bf16'])
@pytest.mark.parametrize('chunks', [1, 7, 8])
def test_trilinear_sample_forward(gather, chunks):
    """N = 203: 7 chunks divide it, 8 do not.  Against glenet_tpu on the
    same volume (the bf16 copy rounds alike) and, for the f32 gather,
    against a float64 oracle (lattice points exact, outside 0)."""
    from glenet_tpu.models import image_vfe as jiv

    from glenet_tpu_torch.models import image_vfe as tiv
    vol, coords = _volume_case()
    jdt, tdt = ((None, None) if gather == 'f32'
                else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(jiv.trilinear_sample(jnp.asarray(vol),
                                          jnp.asarray(coords), jdt, chunks))
    got = tiv.trilinear_sample(torch.from_numpy(vol),
                               torch.from_numpy(coords), tdt,
                               chunks).numpy()
    oracle, _ = _oracle(vol, coords)
    scale = _oracle(np.abs(vol), coords)[0]
    assert got.dtype == np.float32 and got.shape == (203, 16)
    assert np.all(np.abs(got - ref) <= 1e-6 * scale + 1e-7)
    if gather == 'f32':
        assert np.all(np.abs(got - oracle) <= 1e-6 * scale + 1e-7)
        np.testing.assert_array_equal(got[:3], vol[[1, 0, 11], [2, 0, 7],
                                                   [3, 0, 11]])
    else:
        # one bf16 rounding of each gathered value
        assert np.all(np.abs(got - oracle) <= BF16_EPS * scale + 1e-7)
    np.testing.assert_array_equal(got[3], 0.0)


@pytest.mark.parametrize('chunks', [1, 7, 8])
def test_trilinear_sample_backward(chunks):
    """The volume's gradient: the port's f32 sums against a float64
    oracle (f32 rounding), against glenet_tpu's bf16 sums within their
    derived bound, and the numpy model of that bf16 order bit-equal to
    jax.vjp."""
    from glenet_tpu.models import image_vfe as jiv

    from glenet_tpu_torch.models import image_vfe as tiv
    vol, coords = _volume_case(n=2000)
    g = np.random.RandomState(1).randn(2000, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jiv.trilinear_sample(
        v, jnp.asarray(coords), jnp.bfloat16, chunks), jnp.asarray(vol))
    ref = np.asarray(vjp(jnp.asarray(g))[0]).reshape(-1, 16)
    tv = torch.from_numpy(vol).requires_grad_()
    tiv.trilinear_sample(tv, torch.from_numpy(coords), torch.bfloat16,
                         chunks).backward(torch.from_numpy(g))
    got = tv.grad.numpy().reshape(-1, 16)
    # per cell: the contributions' count and absolute sum
    n_rows = got.shape[0]
    exact = np.zeros((n_rows, 16))
    abs_sum = np.zeros((n_rows, 16))
    count = np.zeros(n_rows)
    for rows, wgt in _oracle(vol, coords)[1]:
        ok = rows >= 0
        c = g[ok] * wgt[ok, None]
        np.add.at(exact, rows[ok], c)
        np.add.at(abs_sum, rows[ok], np.abs(c))
        np.add.at(count, rows[ok], 1)
    assert count.max() > 3
    assert np.all(np.abs(got - exact) <= 1e-6 * abs_sum + 1e-12)
    bound = (count[:, None] + 1) * BF16_EPS * abs_sum
    assert np.all(np.abs(got - ref) <= bound + 1e-7)
    idx, wgt = tiv.trilinear_corners(torch.from_numpy(coords), vol.shape[:3])
    mirror = cp.jax_bf16_volume_grad(idx, wgt, torch.from_numpy(g),
                                     n_rows + 1, chunks)
    np.testing.assert_array_equal(mirror[:-1].numpy(), ref)


def _init(module, *args, seed=1, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, **kwargs))
    return tp.random_variables(shapes, seed=seed)


@pytest.mark.parametrize('train', [False, True])
def test_ddn_lite(train):
    """DDNLite's features and depth logits, and in train mode its BN
    stats after the forward."""
    from glenet_tpu.models.image_vfe import DDNLite as JaxDDNLite

    from glenet_tpu_torch.models.image_vfe import DDNLite
    from glenet_tpu_torch.utils.jax_weights import (jax_tree_to_port,
                                                    load_jax_variables)
    img = np.random.RandomState(2).rand(2, 32, 48, 3).astype(np.float32)
    jm = JaxDDNLite(num_bins=12, feat_ch=16)
    v = _init(jm, jnp.asarray(img), train=False)
    (jf, jl), new = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(img),
                             train=train, mutable=['batch_stats'])
    tm = DDNLite(12, feat_ch=16)
    load_jax_variables(tm, v)
    with torch.no_grad():
        tf, tl = tm(torch.from_numpy(img).permute(0, 3, 1, 2), train)
    for got, ref in ((tf, jf), (tl, jl)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=0, atol=1e-5 * np.abs(ref).max())
    if train:
        buffers = dict(tm.named_buffers())
        for k, val in jax_tree_to_port(tm, jax.tree.map(
                np.asarray, new['batch_stats']), 'batch_stats').items():
            np.testing.assert_allclose(buffers[k].numpy(), val, rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def _jax_vfe_apply(cfg, variables, batch, train):
    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.models.image_vfe import ImageVFE as JaxImageVFE
    det = jax_build(cfg)
    _, state = det.net.apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(batch['points']),
        jnp.asarray(batch['points_mask']),
        camera={k: jnp.asarray(batch[k]) for k in cp.CAMERA}, train=train,
        mutable=['batch_stats', 'intermediates'],
        capture_intermediates=lambda m, _: isinstance(m, JaxImageVFE))
    return jax.tree.map(np.asarray, state['intermediates']['vfe'][
        '__call__'][0])


@pytest.mark.parametrize('gather', ['f32', 'bf16'])
def test_image_vfe(gather):
    """The toy CaDDN's ImageVFE (DDNLite, 12 LID bins, 32 x 48 images):
    depth logits within f32 rounding; the voxel features, the port's
    (B, X, Y, Z, C) against glenet_tpu's (B, Z, Y, X, C), within f32
    rounding, plus with the bf16 gather one bf16 ulp of each frustum value
    sampled (its trilinear weight times 2^-8 |value|), the tie's bound."""
    import contextlib

    from glenet_tpu.models.detectors import build_detector as jax_build

    from glenet_tpu_torch.models import image_vfe as tiv
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    cfg = cp.toy_caddn_cfg()
    batch = cp.toy_camera_batch()
    det = jax_build(cfg)
    v = tp.random_variables(jax.eval_shape(
        det.init, jax.random.PRNGKey(0),
        jax.tree.map(jnp.asarray, batch)), seed=1)
    pin = cp.pinned_f32_gather() if gather == 'f32' \
        else contextlib.nullcontext()
    volumes = []
    real = tiv.trilinear_sample

    def record(volume, coords, *args, **kw):
        volumes.append((volume.detach().clone(), coords))
        return real(volume, coords, *args, **kw)

    with pin, pytest.MonkeyPatch.context() as mp:
        ref = _jax_vfe_apply(cfg, v, batch, train=False)
        tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
        load_jax_variables(tdet.net, v)
        mp.setattr(tiv, 'trilinear_sample', record)
        with torch.no_grad():
            out = tdet.net.vfe(*(torch.from_numpy(batch[k])
                                 for k in cp.CAMERA), train=False)
    np.testing.assert_allclose(out['depth_logits'].numpy(),
                               ref['depth_logits'], rtol=0,
                               atol=1e-6 * np.abs(ref['depth_logits']).max())
    got = out['voxel_features'].permute(0, 3, 2, 1, 4).numpy()
    nx, ny, nz = tdet.grid_size
    scale = np.stack([real(vol.abs(), c).numpy() for vol, c in volumes])
    scale = scale.reshape(2, nx, ny, nz, -1).transpose(0, 3, 2, 1, 4)
    tol = 1e-6 * scale + 1e-7
    if gather == 'bf16':
        tol = tol + BF16_ULP * scale
    assert np.all(np.abs(got - ref['voxel_features']) <= tol)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize('train', [False, True])
def test_conv2d_collapse(train):
    """Conv2DCollapse forward, BN stats and backward (input and weights)
    against glenet_tpu's on the same (B, Z, Y, X, C) features."""
    from glenet_tpu.models.image_vfe import Conv2DCollapse as JaxCollapse

    from glenet_tpu_torch.models.image_vfe import Conv2DCollapse
    from glenet_tpu_torch.utils.jax_weights import (jax_tree_to_port,
                                                    load_jax_variables)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 6, 5, 8).astype(np.float32)         # B Z Y X C
    g = rng.randn(2, 6, 5, 16).astype(np.float32)
    jm = JaxCollapse(num_bev_features=16)
    v = _init(jm, jnp.asarray(x), train=False)

    def f(params, xx):
        return jm.apply({'params': params,
                         'batch_stats': v['batch_stats']}, xx, train=train,
                        mutable=['batch_stats'])

    params_j = jax.tree.map(jnp.asarray, v['params'])
    ref, new = f(params_j, jnp.asarray(x))
    _, vjp = jax.vjp(lambda p, xx: f(p, xx)[0], params_j, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    tm = Conv2DCollapse(4 * 8, 16)
    load_jax_variables(tm, v)
    tx = torch.from_numpy(x.transpose(0, 3, 2, 1, 4).copy()).requires_grad_()
    out = tm(tx, train)
    out.backward(torch.from_numpy(g))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    gx = np.asarray(gx).transpose(0, 3, 2, 1, 4)
    np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=0,
                               atol=1e-5 * np.abs(gx).max())
    params = dict(tm.named_parameters())
    for k, val in jax_tree_to_port(tm, jax.tree.map(np.asarray,
                                                    gp)).items():
        np.testing.assert_allclose(params[k].grad.numpy(), val, rtol=0,
                                   atol=2e-5 * np.abs(val).max() + 1e-7,
                                   err_msg=k)
    if train:
        buffers = dict(tm.named_buffers())
        for k, val in jax_tree_to_port(tm, jax.tree.map(
                np.asarray, new['batch_stats']), 'batch_stats').items():
            np.testing.assert_allclose(buffers[k].numpy(), val, rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_ddn_loss():
    """The depth loss and its gradient in the logits: targets from LID
    bins (no depth -> the out-of-range class), fg pixels inside masked-in
    2-D boxes at the feature map's scale."""
    from glenet_tpu.models import image_vfe as jiv

    from glenet_tpu_torch.models import image_vfe as tiv
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 8, 12, 13).astype(np.float32) * 3
    depth = rng.uniform(0, 20, (2, 8, 12)).astype(np.float32)
    depth[:, :2] = 0
    boxes = np.array([[[1, 1, 6, 5], [8, 2, 11, 7], [0, 0, 12, 8]],
                      [[2.5, 3.2, 7.1, 6.9], [0, 0, 0, 0], [0, 0, 0, 0]]],
                     np.float32)
    mask = np.array([[True, True, False], [True, False, False]])
    disc = {'mode': 'LID', 'num_bins': 12, 'depth_min': 2.0,
            'depth_max': 14.8}
    kw = dict(weight=3.0, alpha=0.25, gamma=2.0, fg_weight=13.0,
              bg_weight=1.0)
    ref, vjp = jax.vjp(lambda lg: jiv.ddn_loss(
        lg, jnp.asarray(depth), jnp.asarray(boxes), jnp.asarray(mask), disc,
        **kw), jnp.asarray(logits))
    (gref,) = vjp(jnp.ones_like(ref))
    tl = torch.from_numpy(logits).requires_grad_()
    got = tiv.ddn_loss(tl, torch.from_numpy(depth), torch.from_numpy(boxes),
                       torch.from_numpy(mask), disc, **kw)
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    gref = np.asarray(gref)
    np.testing.assert_allclose(tl.grad.numpy(), gref, rtol=0,
                               atol=1e-5 * np.abs(gref).max())
