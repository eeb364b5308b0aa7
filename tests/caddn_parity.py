"""Helpers of the CaDDN parity tests (tests/test_torch_caddn*.py).

`jax_bf16_volume_grad` reproduces, in numpy, the cotangent glenet_tpu's
`trilinear_sample(..., gather_dtype=jnp.bfloat16)` gives its volume on the
CPU: each corner's contribution g * w rounded to bf16 and scattered into a
fresh bf16 buffer in update order (every add rounded), the corners summed
last to first into a bf16 accumulator, the chunks last to first likewise.
The tests hold it bit-equal to jax.vjp, then give it to the port in place
of its f32 accumulation (`image_vfe.accumulate_volume_grad`), so a whole
model's gradients can be held to f32 tolerances; the f32 accumulation
itself is held to its bound against JAX's in test_torch_image_vfe.py.
"""
import contextlib

import numpy as np
import pytest
import torch


def bf16(x):
    """Round f32 values to bf16 (nearest, ties to even), kept as f32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + (((b >> 16) & 1) + 0x7FFF)) & 0xFFFF0000
    return b.view(np.float32)


def _scatter_rounded(n_rows, rows, vals):
    """A fresh buffer with vals[j] added at rows[j] in order j, each add
    rounded to bf16 (duplicates handled rank by rank)."""
    out = np.zeros((n_rows, vals.shape[1]), np.float32)
    order = np.argsort(rows, kind='stable')
    sr = rows[order]
    start = np.r_[0, np.flatnonzero(np.diff(sr)) + 1]
    rank = np.arange(len(sr)) - np.repeat(start, np.diff(np.r_[start,
                                                                len(sr)]))
    for r in range(rank.max() + 1 if len(rank) else 0):
        sel = order[rank == r]
        out[rows[sel]] = bf16(out[rows[sel]] + vals[sel])
    return out


def jax_bf16_volume_grad(idx, wgt, grad_out, n_rows, chunks):
    """(8, N) idx / wgt and (N, C) grad_out -> (n_rows, C) f32 tensor:
    glenet_tpu's bf16-summed cotangent of its padded volume."""
    idx = idx.cpu().numpy()
    wgt = wgt.detach().cpu().numpy().astype(np.float32)
    g = grad_out.detach().cpu().numpy().astype(np.float32)
    n = g.shape[0]
    n_pad = -n % chunks
    per = (n + n_pad) // chunks
    idx = np.concatenate([idx, np.full((8, n_pad), n_rows - 1)], 1)
    wgt = np.concatenate([wgt, np.zeros((8, n_pad), np.float32)], 1)
    g = np.concatenate([g, np.zeros((n_pad, g.shape[1]), np.float32)])
    tot = np.zeros((n_rows, g.shape[1]), np.float32)
    for k in reversed(range(chunks)):
        sl = slice(k * per, (k + 1) * per)
        acc = np.zeros_like(tot)
        for c in reversed(range(8)):
            fresh = _scatter_rounded(n_rows, idx[c, sl],
                                     bf16(g[sl] * wgt[c, sl, None]))
            acc = bf16(acc + fresh)
        tot = bf16(tot + acc)
    return torch.from_numpy(tot).to(grad_out.device)


def toy_caddn_cfg(deeplab=False):
    """tests/test_caddn.py's toy CaDDN (32 x 48 images, 12 LID bins, a 16 x
    20 x 8 voxel grid, one BEV level, AnchorHeadSingle); with deeplab the
    DDNDeepLabV3 branch (ResNet50, its channel_reduce 256 -> 16)."""
    from test_caddn import make_caddn_cfg
    cfg = make_caddn_cfg()
    if deeplab:
        cfg.MODEL.VFE.FFN.DDN.NAME = 'DDNDeepLabV3'
        cfg.MODEL.VFE.FFN.DDN.BACKBONE_NAME = 'ResNet50'
        cfg.MODEL.VFE.FFN.CHANNEL_REDUCE['in_channels'] = 256
    return cfg


def toy_camera_batch(deeplab=False, seed=42):
    """test_caddn.make_camera_batch as numpy arrays: 32 x 48 images (64 x
    96 for the DeepLab branch, whose layer4 is at 1/8), two Cars each."""
    import jax
    from test_caddn import make_camera_batch
    h, w = (64, 96) if deeplab else (32, 48)
    batch = make_camera_batch(np.random.RandomState(seed), h=h, w=w)
    return jax.tree.map(np.asarray, batch)


def write_toy_caddn_yaml(path, root):
    """A CaDDN yaml over a synthetic camera tree at `root`: the toy model,
    CaDDN.yaml's data config (the camera items, random_image_flip,
    calculate_grid_size, downsample_depth_map) on kitti_dataset.yaml at
    the toy range, B = 2."""
    import json
    from pathlib import Path

    import yaml
    import torch_parity as tp
    root_dir = Path(__file__).resolve().parent.parent
    cfg = json.loads(json.dumps(toy_caddn_cfg()))
    with open(root_dir / 'configs/dataset_configs/kitti_dataset.yaml') as f:
        data = yaml.safe_load(f)
    with open(root_dir / 'configs/kitti_models/CaDDN.yaml') as f:
        caddn = yaml.safe_load(f)['DATA_CONFIG']
    data.update(DATA_PATH=str(root),
                POINT_CLOUD_RANGE=cfg['DATA_CONFIG']['POINT_CLOUD_RANGE'],
                GET_ITEM_LIST=caddn['GET_ITEM_LIST'],
                DATA_AUGMENTOR=caddn['DATA_AUGMENTOR'],
                DATA_PROCESSOR=caddn['DATA_PROCESSOR'],
                MAX_POINTS_PER_SCENE=4096, MAX_GT_PER_SCENE=16)
    data['DATA_PROCESSOR'][1]['VOXEL_SIZE'] = \
        cfg['DATA_CONFIG']['DATA_PROCESSOR'][0]['VOXEL_SIZE']
    cfg['DATA_CONFIG'] = data
    cfg['OPTIMIZATION'] = dict(tp.TINY_OPTIMIZATION)
    cfg['MODEL']['POST_PROCESSING']['EVAL_METRIC'] = 'kitti'
    Path(path).write_text(yaml.safe_dump(cfg))
    return path


def jax_batchnorm_filter(module, _name):
    """capture_intermediates filter: every BN of glenet_tpu (flax's
    nn.BatchNorm of the DeepLabV3 depth network's `_BN`, MaskedBatchNorm)."""
    import flax.linen as nn

    from glenet_tpu.models.layers import MaskedBatchNorm
    return isinstance(module, (nn.BatchNorm, MaskedBatchNorm))


def align_batchnorm_outputs(net, ref_outputs, rel=1e-4, pool_rel=1e-2):
    """Hooks on every BN of the port's `net` (ddn_deeplab.BatchNorm and
    MaskedBatchNorm): its output takes JAX's value (`ref_outputs`,
    tp.jax_bn_outputs of the jax_batchnorm_filter capture), the gradient
    path unchanged.  Both packages take the train-mode moments in one
    pass, E[x^2] - E[x]^2, of conv outputs whose mean is up to ~7 x their
    deviation (ReLU outputs in): the summation order then moves the
    variance by ~50 x f32 rounding, so the two outputs may differ by up to
    `rel` of the module's largest |output|; any larger difference fails.
    ASPP's pool branch (`bn_pool`) normalises B values per channel, B = 2
    nearly equal ones here: its output (a - m) / sqrt(var + 1e-5) has a
    slope of up to 1 / sqrt(1e-5) = 316 in its inputs, so it may differ by
    `pool_rel`.
    Returns (a dict whose 'max_rel' is the largest difference seen,
    relative, the hook handles)."""
    from glenet_tpu_torch.models.ddn_deeplab import BatchNorm
    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    seen = {'max_rel': 0.0}
    calls = {name: list(outs) for name, outs in ref_outputs.items()}

    def hook(name):
        def fn(mod, _inp, y):
            cdim = getattr(mod, 'channel_dim', 1) % y.dim()
            ref = torch.from_numpy(np.array(calls[name].pop(0))).movedim(
                -1, cdim)
            assert ref.shape == y.shape, (name, ref.shape, y.shape)
            diff = float((y - ref).abs().max() / ref.abs().max())
            tol = pool_rel if 'bn_pool' in name else rel
            assert diff <= tol, (name, diff, tol)
            seen['max_rel'] = max(seen['max_rel'], diff)
            return y + (ref - y).detach()
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in
               net.named_modules()
               if isinstance(m, (BatchNorm, MaskedBatchNorm))]
    assert len(handles) == len(calls) > 0
    return seen, handles


@contextlib.contextmanager
def pinned_f32_gather():
    """Both packages' frustum sampling gathers from the f32 volume (the
    bf16 gather is held on its own in test_torch_image_vfe.py), as
    torch_parity.pinned_f32 pins the sparse gathers."""
    from glenet_tpu.models import image_vfe as jiv

    from glenet_tpu_torch.models import image_vfe as tiv
    real = jiv.trilinear_sample

    def f32_sample(volume, coords, gather_dtype=None, chunks=8):
        return real(volume, coords, gather_dtype=None, chunks=chunks)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jiv, 'trilinear_sample', f32_sample)
        mp.setattr(tiv, 'GATHER_DTYPE', None)
        yield


CAMERA = ('images', 'trans_lidar_to_cam', 'trans_cam_to_img', 'image_shape')


def align_voxel_features(net, ref_vox):
    """A hook on the port's ImageVFE: its voxel features take JAX's
    (`ref_vox`, (B, Z, Y, X, C)), the gradient path unchanged.  With the
    bf16 gather a frustum value within rounding of a bf16 rounding
    boundary rounds differently in the two packages: a feature may differ
    by one bf16 ulp (at most 2^-7 relative) of the largest frustum value,
    checked as 2^-7 of the largest |feature|.  Returns the handle."""
    ref = torch.from_numpy(np.array(ref_vox)).permute(0, 3, 2, 1, 4)

    def fn(_mod, _inp, out):
        y = out['voxel_features']
        assert float((y - ref).abs().max()) <= 2.0 ** -7 * float(
            ref.abs().max())
        return dict(out, voxel_features=y + (ref - y).detach())
    return net.vfe.register_forward_hook(fn)


def run_caddn_step(cfg, batch, total_steps=100, align_bn=False,
                   align_vox=False, weights_seed=1):
    """One train step of glenet_tpu (jitted, as its train step) and one of
    the port's train_state on a CaDDN `cfg`, the same numpy-drawn weights
    and `batch`.  Returns (JAX's metrics, grads, batch_stats and params
    after adam_onecycle; the port's metrics, gradients by port key and
    detector).  With align_bn, JAX's BN outputs are captured in the same
    jitted forward and the port's BNs take them (align_batchnorm_outputs;
    the largest difference is ref['bn_max_rel']); with align_vox, its
    voxel features (align_voxel_features)."""
    import jax
    import jax.numpy as jnp
    import optax

    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.train import optim as joptim

    import torch_parity as tp
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.train import optim
    from glenet_tpu_torch.train import state as st
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    det = jax_build(cfg)
    tp.assert_assigner_margin(det, batch)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jax.tree.map(jnp.asarray, batch))
    variables = tp.random_variables(shapes, seed=weights_seed)
    tx, _ = joptim.build_optimizer(cfg.OPTIMIZATION, total_steps)
    from glenet_tpu.models.image_vfe import ImageVFE
    mutable = ['batch_stats'] + (['intermediates']
                                 if align_bn or align_vox else [])

    def capture(mdl, name):
        return ((align_bn and jax_batchnorm_filter(mdl, name))
                or (align_vox and isinstance(mdl, ImageVFE)))

    @jax.jit
    def jax_step(v, bt):
        def loss_fn(params):
            out, new_state = det.net.apply(
                {'params': params, 'batch_stats': v['batch_stats']},
                bt['points'], bt['points_mask'], gt_boxes=bt['gt_boxes'],
                gt_mask=bt['gt_mask'], gt_uncertainty=bt['gt_uncertainty'],
                camera={k: bt[k] for k in CAMERA}, train=True,
                mutable=mutable, capture_intermediates=capture)
            loss, metrics = det.compute_loss(out, bt)
            return loss, (metrics, new_state)

        grads, (metrics, new_state) = jax.grad(
            loss_fn, has_aux=True)(v['params'])
        upd, _ = tx.update(grads, tx.init(v['params']), v['params'])
        metrics['grad_norm'] = optax.global_norm(grads)
        return {'metrics': metrics, 'grads': grads,
                'batch_stats': new_state['batch_stats'],
                'params': optax.apply_updates(v['params'], upd),
                'bn_out': new_state.get('intermediates', {})}

    ref = jax.tree.map(np.asarray, jax_step(
        jax.tree.map(jnp.asarray, variables),
        jax.tree.map(jnp.asarray, batch)))
    tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
    load_jax_variables(tdet.net, variables)
    ttx, _ = optim.build_optimizer(tp.to_port_cfg(cfg).OPTIMIZATION,
                                   total_steps)
    state = st.create_train_state(tdet, ttx)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    bn_out, hooks = ref.pop('bn_out'), []
    if align_vox:
        vox = bn_out['vfe'].pop('__call__')[0]['voxel_features']
        hooks.append(align_voxel_features(tdet.net, vox))
    if align_bn:
        seen, bn_hooks = align_batchnorm_outputs(tdet.net,
                                                 tp.jax_bn_outputs(bn_out))
        hooks += bn_hooks
    _, metrics = st.make_train_step(tdet, ttx)(state, tbatch)
    for h in hooks:
        h.remove()
    if align_bn:
        ref['bn_max_rel'] = seen['max_rel']
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in tdet.net.named_parameters()}
    return ref, metrics, grads, tdet
