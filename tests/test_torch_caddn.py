"""The whole toy CaDDN (tests/test_caddn.py's make_caddn_cfg: 32 x 48
images, 12 LID bins, a 16 x 20 x 8 grid, one BEV level, AnchorHeadSingle,
the final nms_gpu) in the port against glenet_tpu on the CPU, with
DDNLite and with the DDNDeepLabV3 branch (ResNet50, 64 x 96 images, its
channel_reduce block): predict's dense-head outputs and final boxes, and
one train step's loss terms (loss_depth among them), every gradient, the
BN stats and the parameters after adam_onecycle.

The frustum sampling gathers from the f32 volume in both packages
(caddn_parity.pinned_f32_gather, as torch_parity.pinned_f32 pins the sparse
gathers); the bf16 gather is held on its own in test_torch_image_vfe.py,
and here end to end at the production dtype with its tie bound: a tie
moves a voxel feature by one bf16 ulp of a frustum value, which moves the
dense head's outputs by < 1e-4 of their range at these sizes, so predict
is held as the f32 one; in a train step the port's voxel features take
JAX's (caddn_parity.align_voxel_features, a shift within that ulp,
checked), then the loss terms and the gradients of every module after
the sampling are held at f32 tolerance (the sampling's backward,
bf16-summed in glenet_tpu, f32 in the port, is held to its derived bound
in test_torch_image_vfe.py).

The DeepLab train step runs at B = 1 with every BN output aligned to
JAX's (caddn_parity.align_batchnorm_outputs, a shift within 1e-4 of each
output's range, checked): with B = 2 ASPP's pool-branch BN normalises two
nearly equal values per channel, whose slope of up to 1 / sqrt(eps)
magnifies f32 rounding into ~1e-3 of the gradients; with B = 1 that
branch passes no gradient in either package."""
import contextlib

import numpy as np
import pytest

pytest.importorskip('jax')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import caddn_parity as cp  # noqa: E402
import torch_parity as tp  # noqa: E402


def _cfg(deeplab):
    from glenet_tpu.config import Cfg
    cfg = cp.toy_caddn_cfg(deeplab)
    cfg.OPTIMIZATION = Cfg(dict(tp.TINY_OPTIMIZATION))
    return cfg


def _run_predict(cfg, batch):
    from glenet_tpu.models.detectors import build_detector as jax_build

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    det = jax_build(cfg)
    jb = jax.tree.map(jnp.asarray, batch)
    v = tp.random_variables(jax.eval_shape(det.init, jax.random.PRNGKey(0),
                                           jb), seed=1)

    @jax.jit
    def run(vv, b):
        full = det.net_eval.apply(vv, b['points'], b['points_mask'],
                                  camera={k: b[k] for k in cp.CAMERA},
                                  train=False)
        return full['dense_head'], det.predict(vv, b)

    head, pred = jax.tree.map(np.asarray, run(jax.tree.map(jnp.asarray, v),
                                              jb))
    tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
    load_jax_variables(tdet.net, v)
    tb = {k: torch.from_numpy(np.array(x)) for k, x in batch.items()}
    with torch.no_grad():
        full = tdet.net(None, None, camera=tb)
        tpred = tdet.finalize(full)
    return head, pred, full['dense_head'], tpred


@pytest.mark.parametrize('gather', ['f32', 'bf16'])
@pytest.mark.parametrize('deeplab', [False, True])
def test_predict(deeplab, gather):
    batch = cp.toy_camera_batch(deeplab)
    pin = (cp.pinned_f32_gather() if gather == 'f32'
           else contextlib.nullcontext())
    with pin:
        head, pred, thead, tpred = _run_predict(_cfg(deeplab), batch)
    for k, ref in head.items():
        tp.assert_close(thead[k].numpy(), ref, rtol=0,
                        atol=1e-4 * np.abs(ref).max(), err_msg=k)
    tp.assert_predict_equal(tpred, pred)


def _assert_step(ref, metrics, grads, tdet, skip=()):
    from glenet_tpu_torch.utils.jax_weights import jax_tree_to_port
    # with skipped gradients their norm is not held either
    drop = ('grad_norm',) if skip else ()
    tp.assert_loss_terms_equal(
        {k: v for k, v in metrics.items() if k not in drop},
        {k: v for k, v in ref['metrics'].items() if k not in drop})
    assert float(metrics['loss_depth']) > 0
    ref_grads = {k: v for k, v in jax_tree_to_port(
        tdet.net, ref['grads']).items() if not k.startswith(skip)}
    tp.assert_grads_equal({k: grads[k] for k in ref_grads}, ref_grads, tdet,
                          port_keys=True)


@pytest.mark.parametrize('deeplab', [False, True])
def test_train_step(deeplab):
    """One step at f32 gathers: loss terms, every gradient, BN stats after
    the step, parameters after adam_onecycle."""
    batch = cp.toy_camera_batch(deeplab)
    if deeplab:
        batch = {k: v[:1] for k, v in batch.items()}
    cfg = _cfg(deeplab)
    with cp.pinned_f32_gather():
        ref, metrics, grads, tdet = cp.run_caddn_step(cfg, batch,
                                                      align_bn=deeplab)
    if deeplab:
        assert 0 < ref['bn_max_rel'] <= 1e-4
    _assert_step(ref, metrics, grads, tdet)
    np.testing.assert_allclose(float(metrics['grad_norm']),
                               float(ref['metrics']['grad_norm']), rtol=1e-4)
    tp.assert_bn_stats_equal(tdet, ref['batch_stats'])
    tp.assert_params_after_adam(tdet, ref, grads,
                                lr=float(cfg.OPTIMIZATION.LR))


def test_train_step_bf16_gather():
    """The production bf16 gather end to end: loss terms, and every
    gradient after the sampling (Conv2DCollapse, the BEV backbone, the
    head) at f32 tolerance."""
    cfg = _cfg(False)
    ref, metrics, grads, tdet = cp.run_caddn_step(cfg, cp.toy_camera_batch(),
                                                  align_vox=True)
    _assert_step(ref, metrics, grads, tdet, skip=('vfe.',))


@pytest.mark.parametrize('deeplab', [False, True])
def test_msgpack_checkpoint_and_bridge(deeplab, tmp_path):
    """A glenet_tpu checkpoint of the toy CaDDN (its `_BN` leaves under
    `<name>/BatchNorm_0` with the DeepLab branch) through the port's
    .msgpack reader into build_detector_from_checkpoint: every parameter
    and BN stat lands, port_to_jax_variables gives the tree back, and the
    predict equals JAX's on the saved variables."""
    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.train import checkpoint as ckpt_lib
    from glenet_tpu.train import optim
    from glenet_tpu.train import state as state_lib

    from glenet_tpu_torch.train import jax_checkpoint
    from glenet_tpu_torch.utils.jax_weights import port_to_jax_variables
    cfg = _cfg(deeplab)
    batch = cp.toy_camera_batch(deeplab)
    det = jax_build(cfg)
    v = tp.random_variables(jax.eval_shape(
        det.init, jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch)),
        seed=3)
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    params = jax.tree.map(jnp.asarray, v['params'])
    ts = state_lib.TrainState(
        step=jnp.asarray(5, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v['batch_stats']),
        opt_state=tx.init(params))
    path = ckpt_lib.save_checkpoint(ckpt_lib.checkpoint_state(ts, 1, 5),
                                    tmp_path, 1)
    tdet = jax_checkpoint.build_detector_from_checkpoint(
        tp.to_port_cfg(cfg), path, device='cpu')
    back = port_to_jax_variables(tdet.net)
    flat_ref = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_got)
    for key, leaf in flat_ref:
        np.testing.assert_array_equal(flat_got[key], leaf, err_msg=str(key))
    with cp.pinned_f32_gather():
        tb = {k: torch.from_numpy(np.array(x)) for k, x in batch.items()}
        pred = jax.tree.map(np.asarray, jax.jit(det.predict)(
            jax.tree.map(jnp.asarray, v), jax.tree.map(jnp.asarray, batch)))
        tp.assert_predict_equal(tdet.predict(tb), pred)


@pytest.mark.parametrize('name', ['CaDDN.yaml', 'CaDDN_deeplab.yaml'])
def test_full_model_converter_refuses_caddn(name):
    """The converter of full reference checkpoints refuses CaDDN's
    ImageVFE by name before it reads a key, as glenet_tpu's does; its
    depth network converts on its own (convert_ddn_deeplabv3,
    test_torch_ddn_deeplab.py)."""
    from pathlib import Path

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.utils import weight_converter as wc
    cfg = cfg_from_yaml_file(str(Path(__file__).resolve().parent.parent
                                 / 'configs/kitti_models' / name))
    with pytest.raises(NotImplementedError, match='ImageVFE'):
        wc.convert_full_model(cfg, {}, {'params': {}})
