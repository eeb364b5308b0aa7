"""The modules of the port's single-stage SECONDNet family (GLENet-S,
GLENet-C, plain SECOND) against glenet_tpu, numpy-drawn f32 inputs and
weights on both sides:

  - utils/losses.kl_label_reg_loss (its three parts, gradients) and the
    anchor-head regression losses reg_loss_kl_label / reg_loss_kl;
  - the IoU branch's loss (target 2 * IoU3D(pred, gt) - 1 without
    gradient);
  - the dense heads under each of the six DENSE_HEAD names (outputs and
    decode_predictions, variance and IoU outputs included);
  - SSFA on an even 16 x 12 map: eval and train forwards and BN running
    stats; its gradients on an 8 x 6 map; the weight bridge's
    deconvolution flip both ways.

Tolerances: values rtol 1e-4 / atol 1e-5 (f32 sums in another order);
gradients per tensor max |diff| <= 1e-4 max |grad| + 1e-5; the bridge's
round trip exactly.  A ReLU input within f32 rounding of 0 takes either
side of the kink in either package and moves a BN bias gradient by a whole
element's gradient (seen once on the 16 x 12 map), so the gradient case
asserts a margin of 1e-5 around 0 at every ReLU first."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from glenet_tpu.models import anchor_heads as jah  # noqa: E402
from glenet_tpu.utils import box_coder as jbc  # noqa: E402
from glenet_tpu.utils import losses as jl  # noqa: E402

from glenet_tpu_torch.models import anchor_heads as tah  # noqa: E402
from glenet_tpu_torch.utils import box_coder as tbc  # noqa: E402
from glenet_tpu_torch.utils import jax_weights  # noqa: E402
from glenet_tpu_torch.utils import losses as tl  # noqa: E402

HEADS = {'AnchorHeadSingle': None,
         'AnchorHeadKLLabel': {},
         'AnchorHeadKL': {},
         'AnchorHeadKLLabelIoU': {'with_iou_branch': True},
         'AnchorHeadKLLabelIoUGuide': {'with_iou_branch': True,
                                       'with_guide': True},
         'AnchorHeadIoU': {'with_iou_branch': True, 'with_std_branch': False}}


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, shape):
    b = np.zeros((*shape, 7), np.float32)
    b[..., :2] = rng.uniform(-6, 6, (*shape, 2))
    b[..., 2] = rng.uniform(-1.5, 0.5, shape)
    b[..., 3:6] = rng.uniform([3.2, 1.4, 1.3], [4.6, 1.9, 1.8], (*shape, 3))
    b[..., 6] = rng.uniform(-np.pi, np.pi, shape)
    return b


def _case(seed, b=2, n=300):
    """Anchors (n, 7), box preds / log variances / targets (b, n, 7),
    labels (-1 ignored, 0 background, 1 positive; sample 1 without
    positives), label variances (0 off the positives, as the assigner
    leaves them)."""
    rng = np.random.RandomState(seed)
    labels = rng.choice([-1, 0, 1], size=(b, n), p=[0.2, 0.5, 0.3])
    labels[1] = np.where(labels[1] > 0, 0, labels[1])
    unc = rng.uniform(0.01, 0.3, (b, n, 7)) * (labels > 0)[..., None]
    return {'anchors': _boxes(rng, (n,)),
            'box_preds': (rng.randn(b, n, 7) * 0.3).astype(np.float32),
            'std_preds': (rng.randn(b, n, 7) * 2).astype(np.float32),
            'targets': (rng.randn(b, n, 7) * 0.3).astype(np.float32),
            'labels': labels.astype(np.int32),
            'unc': unc.astype(np.float32),
            'iou_preds': rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)}


def _close(got, ref, what=''):
    tp.assert_close(np.asarray(got.detach() if torch.is_tensor(got)
                               else got), np.asarray(ref), err_msg=what)


def _check_value_and_grads(jax_fn, torch_fn, arrays):
    """fn(*arrays) -> scalar in both packages: values, and gradients with
    respect to every array."""
    ref, ref_g = jax.value_and_grad(
        jax_fn, argnums=tuple(range(len(arrays))))(*arrays)
    ts = [_t(a).requires_grad_(True) for a in arrays]
    got = torch_fn(*ts)
    got.backward()
    _close(got, ref, 'value')
    for i, (t, g) in enumerate(zip(ts, ref_g)):
        _close(t.grad if t.grad is not None else torch.zeros_like(t), g,
               f'gradient {i}')


def test_kl_label_reg_loss():
    """The three parts, each and summed, with gradients; background
    anchors carry a variance of 0 (t = log 1e-10) and weight 0."""
    c = _case(0)
    pos = (c['labels'] > 0).astype(np.float32)
    w = pos / np.maximum(pos.sum(1, keepdims=True), 1)
    cw = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0]
    ref_total, ref_parts = jl.kl_label_reg_loss(
        c['box_preds'], c['std_preds'], c['targets'], w, c['unc'],
        code_weights=cw)
    total, parts = tl.kl_label_reg_loss(
        _t(c['box_preds']), _t(c['std_preds']), _t(c['targets']), _t(w),
        _t(c['unc']), code_weights=cw)
    assert sorted(parts) == ['loc_loss_log', 'loc_loss_square',
                             'loc_loss_src']
    _close(total, ref_total, 'total')
    for k, v in ref_parts.items():
        assert abs(float(v)) > 0, k
        _close(parts[k], v, k)
    for part in sorted(parts):
        _check_value_and_grads(
            lambda p, s: jl.kl_label_reg_loss(p, s, c['targets'], w,
                                              c['unc'])[1][part],
            lambda p, s: tl.kl_label_reg_loss(p, s, _t(c['targets']), _t(w),
                                              _t(c['unc']))[1][part],
            [c['box_preds'], c['std_preds']])


def test_anchor_head_kl_losses():
    """reg_loss_kl_label (with its parts over the batch size) and
    reg_loss_kl, values and gradients."""
    c = _case(1)
    labels, unc, tgt = c['labels'], c['unc'], c['targets']
    ref, ref_parts = jah.reg_loss_kl_label(c['box_preds'], c['std_preds'],
                                           tgt, labels, unc)
    got, parts = tah.reg_loss_kl_label(_t(c['box_preds']), _t(c['std_preds']),
                                       _t(tgt), _t(labels), _t(unc))
    _close(got, ref)
    for k, v in ref_parts.items():
        _close(parts[k], v, k)
    _check_value_and_grads(
        lambda p, s: jah.reg_loss_kl_label(p, s, tgt, labels, unc)[0],
        lambda p, s: tah.reg_loss_kl_label(p, s, _t(tgt), _t(labels),
                                           _t(unc))[0],
        [c['box_preds'], c['std_preds']])
    _check_value_and_grads(
        lambda p, s: jah.reg_loss_kl(p, s, tgt, labels),
        lambda p, s: tah.reg_loss_kl(p, s, _t(tgt), _t(labels)),
        [c['box_preds'], c['std_preds']])


def test_iou_branch_loss():
    """Smooth-L1 of iou_preds[..., 0] against 2 * IoU3D(decoded pred,
    decoded gt) - 1 over positives; the target carries no gradient, so the
    box predictions get none."""
    c = _case(2)
    anchors, labels, tgt = c['anchors'], c['labels'], c['targets']
    jcoder, tcoder = jbc.ResidualCoder(), tbc.ResidualCoder()
    _check_value_and_grads(
        lambda i, p: jah.iou_branch_loss(i, p, tgt, labels, anchors, jcoder),
        lambda i, p: tah.iou_branch_loss(i, p, _t(tgt), _t(labels),
                                         _t(anchors), tcoder),
        [c['iou_preds'], c['box_preds']])


def _jax_head(name, a, num_class):
    kw = HEADS[name]
    common = dict(num_class=num_class, num_anchors_per_location=a,
                  code_size=7, num_dir_bins=2)
    if kw is None:
        return jah.AnchorHeadSingle(**common)
    return jah.AnchorHeadKLLabel(**common, **kw)


@pytest.mark.parametrize('name', sorted(HEADS))
def test_dense_head(name):
    """Every output of the head built from DENSE_HEAD.NAME, and its decode
    (boxes with the direction correction, log variances, IoU outputs)."""
    a, num_class, h, w, c = 4, 2, 6, 5, 24
    rng = np.random.RandomState(3)
    x = rng.randn(2, h, w, c).astype(np.float32)
    jhead = _jax_head(name, a, num_class)
    variables = tp.random_variables(jax.eval_shape(
        jhead.init, jax.random.PRNGKey(0), x), seed=4)
    ref = jhead.apply(variables, x, train=False)
    head = tah.build_dense_head(name, c, num_class, a, 7, 2)
    jax_weights.load_jax_variables(head, variables)
    with torch.no_grad():
        out = head(_t(x))
    assert sorted(out) == sorted(ref)
    has_std = name != 'AnchorHeadIoU' and name != 'AnchorHeadSingle'
    assert ('box_std_preds' in out) == has_std
    assert ('iou_preds' in out) == ('IoU' in name)
    for k, v in ref.items():
        _close(out[k], v, k)
    anchors = _boxes(rng, (h * w * a,))
    ref_dec = jah.decode_predictions(ref, jnp.asarray(anchors),
                                     jbc.ResidualCoder())
    dec = tah.decode_predictions(out, _t(anchors), tbc.ResidualCoder())
    assert sorted(dec) == sorted(ref_dec)
    for k, v in ref_dec.items():
        _close(dec[k], v, k)


def _ssfa(train, shape=(2, 16, 12)):
    """JAX's SSFA on a (*shape, 32) map with numpy-drawn variables:
    (input, variables, output, new batch_stats or None, gradients of
    sum(output * probe) or None, probe)."""
    from glenet_tpu.models.bev_backbone import SSFA
    rng = np.random.RandomState(5)
    x = rng.randn(*shape, 32).astype(np.float32)
    probe = rng.randn(*shape, 128).astype(np.float32)
    m = SSFA()
    variables = tp.random_variables(jax.eval_shape(
        m.init, jax.random.PRNGKey(0), x), seed=6)
    if not train:
        return x, variables, m.apply(variables, x, train=False), None, None, \
            probe

    def loss(params):
        out, st = m.apply({'params': params,
                           'batch_stats': variables['batch_stats']}, x,
                          train=True, mutable=['batch_stats'])
        return (out * probe).sum(), (out, st['batch_stats'])

    grads, (out, stats) = jax.grad(loss, has_aux=True)(variables['params'])
    return x, variables, out, stats, grads, probe


@pytest.mark.parametrize('train', [False, True])
def test_ssfa(train):
    """Eval mode (running stats) and train mode (batch moments): output
    (B, H, W, 128) at the input's size, and in train mode the BN running
    stats."""
    from glenet_tpu_torch.models.bev_backbone import SSFA
    x, variables, ref, ref_stats, _, _ = _ssfa(train)
    net = SSFA(32)
    jax_weights.load_jax_variables(net, variables)
    with torch.no_grad():
        out = net(_t(x), train)
    assert tuple(out.shape) == (2, 16, 12, 128)
    _close(out, ref, 'output')
    if train:
        bufs = dict(net.named_buffers())
        for k, v in jax_weights.jax_tree_to_port(net, ref_stats,
                                                 'batch_stats').items():
            _close(bufs[k], v, k)


def test_ssfa_gradients():
    """Every parameter's gradient of sum(output * probe) in train mode."""
    from glenet_tpu_torch.models.bev_backbone import SSFA
    from glenet_tpu_torch.models.layers import ConvBlock
    x, variables, ref, _, ref_grads, probe = _ssfa(True, (1, 8, 6))
    net = SSFA(32)
    jax_weights.load_jax_variables(net, variables)
    relu_in = []
    for m in net.modules():
        if isinstance(m, ConvBlock) and m.use_relu:
            m.MaskedBatchNorm_0.register_forward_hook(
                lambda _m, _i, o: relu_in.append(o.detach()))
    out = net(_t(x), True)
    assert min(float(t.abs().min()) for t in relu_in) > 1e-5
    _close(out, ref, 'output')
    (out * _t(probe)).sum().backward()
    grads = {n: p.grad for n, p in net.named_parameters()}
    ref_grads = jax_weights.jax_tree_to_port(net, ref_grads)
    assert set(grads) == set(ref_grads)
    for k, g in ref_grads.items():
        tol = 1e-4 * np.abs(g).max() + 1e-5
        assert float((grads[k] - _t(g)).abs().max()) <= tol, k


def test_ssfa_bridge_round_trip():
    """The deconvolutions' kernels sit on the ConvBlock (JAX (kH, kW, I, O),
    lhs-dilated correlation) and become torch's ConvTranspose2d weight by a
    spatial flip: JAX -> port -> JAX and port -> JAX -> port are the
    identity."""
    from glenet_tpu_torch.models.bev_backbone import SSFA
    _, variables, _, _, _, _ = _ssfa(False)
    net = SSFA(32)
    jax_weights.load_jax_variables(net, variables)
    back = jax_weights.port_to_jax_variables(net)
    assert back['params']['deconv_0']['kernel'].shape == (3, 3, 256, 128)
    ref = dict(tp_leaves(variables))
    got = dict(tp_leaves(back))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    torch.manual_seed(0)
    fresh = SSFA(32)
    exported = jax_weights.port_to_jax_variables(fresh)
    again = SSFA(32)
    jax_weights.load_jax_variables(again, exported)
    for k, v in fresh.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def tp_leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from tp_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)
