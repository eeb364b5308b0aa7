"""The port's converter of reference (pcdet) checkpoints
(glenet_tpu_torch/utils/weight_converter.py) against glenet_tpu's
(glenet_tpu/utils/weight_converter.py), on the CPU.

  - one synthetic pcdet state dict, written here from the JAX variable
    shapes (the roi head as tests/test_voxel_query_pool.py writes it, plus
    the backbone, BEV and dense-head keys), through both converters into
    the same template: the trees are EXACTLY equal leaf by leaf, with equal
    `unconsumed` lists, in voxel_query mode (plain and KL head) and in
    corner mode (the roi head left at the template, its keys unconsumed);
  - the port's template (its own net exported in the JAX layout) has the
    JAX tree's paths and shapes, and loads back bit-exactly;
  - the port's predict on the converted weights equals JAX's (final boxes
    and scores atol 1e-4, valid masks and labels equal);
  - utils/synthetic.pcdet_state_dict, the port's own writer of such state
    dicts, is consumed whole by JAX's converter at the toy config and at
    GLENet_VR_vq.yaml and voxel_rcnn_car.yaml, every leaf in the template's
    shape;
  - the convert_weights CLI, then `tools.test --ckpt`, on the CPU;
  - PV-RCNN++ (both Waymo yamls at full width): both converters fill
    stage 1 equally and leave every pfe.*, point_head.* and roi_head.* key
    unconsumed; the toy's JAX variables round-trip through the bridge
    exactly."""
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MODES = ('voxel_query', 'voxel_query_plain', 'corner')


def _cfg(mode):
    """The toy two-stage config on KITTI's z range (a BEV fold of depth 2,
    so the HeightCompression channel permutation matters)."""
    cfg = tp.tiny_twostage_cfg(384)
    pc = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    pc[2], pc[5] = -3.0, 1.0
    if mode != 'corner':
        tp.voxel_query_cfg(cfg)
    if mode == 'voxel_query_plain':
        tp.plain_voxel_rcnn_cfg(cfg)
    return cfg


def _template(cfg):
    """JAX's initialised variables (numpy) and the port's exported net."""
    import jax.numpy as jnp

    from __graft_entry__ import _make_batch
    from glenet_tpu.models.detectors import build_detector as jax_build

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import port_to_jax_variables
    batch = _make_batch(1, n_points=64,
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    det = jax_build(cfg)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jax.tree.map(jnp.asarray, batch))
    variables = tp.random_variables(shapes, seed=2)
    tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
    return variables, port_to_jax_variables(tdet.net), tdet


def _pcdet_sd_from_flax(cfg, variables, seed):
    """A reference-layout state dict of random tensors written from the
    JAX variable shapes."""
    rng = np.random.RandomState(seed)
    params = variables['params']
    sd = {}

    def rand(shape):
        """N(0, 1/fan_in) for a weight (fan_in: every axis but the first),
        N(0, 0.1) for a vector."""
        scale = 0.1 if len(shape) == 1 else np.prod(shape[1:]) ** -0.5
        return (rng.randn(*shape) * scale).astype(np.float32)

    def put_bn(key, c):
        sd[f'{key}.weight'] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f'{key}.bias'] = rand((c,))
        sd[f'{key}.running_mean'] = rand((c,))
        sd[f'{key}.running_var'] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        sd[f'{key}.num_batches_tracked'] = np.array(7, np.int64)

    def put_lin(key, o, i, bias):
        sd[f'{key}.weight'] = rand((o, i))
        if bias:
            sd[f'{key}.bias'] = rand((o,))

    # VoxelBackBone8x, spconv 2.x (O, kz, ky, kx, I)
    bb = params['backbone_3d']
    names = {'conv_input': 'conv_input', 'conv1_0': 'conv1.0',
             'conv_out': 'conv_out'}
    for lvl in (2, 3, 4):
        names[f'conv{lvl}_down'] = f'conv{lvl}.0'
        for j in range(2):
            names[f'conv{lvl}_{j}'] = f'conv{lvl}.{j + 1}'
    for ours, ref in names.items():
        k, ci, co = bb[ours]['kernel'].shape
        kzyx = (3, 3, 3) if k == 27 else (3, 1, 1)
        sd[f'backbone_3d.{ref}.0.weight'] = rand((co, *kzyx, ci))
        put_bn(f'backbone_3d.{ref}.1', co)

    # BaseBEVBackbone: ConvBlock_k in call order
    bev = params['backbone_2d']
    k = 0
    for i, n in enumerate(cfg.MODEL.BACKBONE_2D.LAYER_NUMS):
        keys = [(f'blocks.{i}.1', f'blocks.{i}.2')]
        keys += [(f'blocks.{i}.{4 + 3 * j}', f'blocks.{i}.{5 + 3 * j}')
                 for j in range(n)]
        for conv, bn in keys:
            kh, kw, ci, co = bev[f'ConvBlock_{k}']['Conv_0']['kernel'].shape
            sd[f'backbone_2d.{conv}.weight'] = rand((co, ci, kh, kw))
            put_bn(f'backbone_2d.{bn}', co)
            k += 1
        kh, kw, ci, co = bev[f'ConvBlock_{k}']['ConvTranspose_0'][
            'kernel'].shape
        sd[f'backbone_2d.deblocks.{i}.0.weight'] = rand((ci, co, kh, kw))
        put_bn(f'backbone_2d.deblocks.{i}.1', co)
        k += 1

    # AnchorHeadSingle 1x1 convs
    for name, leaves in params['dense_head'].items():
        _, _, ci, co = leaves['kernel'].shape
        sd[f'dense_head.{name}.weight'] = rand((co, ci, 1, 1))
        sd[f'dense_head.{name}.bias'] = rand((co,))

    # the roi head (tests/test_voxel_query_pool.py's layout)
    head = cfg.MODEL.ROI_HEAD
    roi = params['roi_head']
    pool = head.ROI_GRID_POOL
    for k, src in enumerate(pool.FEATURES_SOURCE):
        mid, out = pool.POOL_LAYERS[src]['MLPS'][0]
        cin = roi[f'pool_{src}']['mlp_in']['kernel'].shape[0]
        base = f'roi_head.roi_grid_pool_layers.{k}'
        sd[f'{base}.mlps_in.0.0.weight'] = rand((mid, cin, 1))
        put_bn(f'{base}.mlps_in.0.1', mid)
        sd[f'{base}.mlps_pos.0.0.weight'] = rand((mid, 3, 1, 1))
        put_bn(f'{base}.mlps_pos.0.1', mid)
        sd[f'{base}.mlps_out.0.0.weight'] = rand((out, mid, 1))
        put_bn(f'{base}.mlps_out.0.1', out)
    pre = roi['shared_0']['kernel'].shape[0]
    for tname, sizes, cin in (
            ('shared_fc_layer', head.SHARED_FC, pre),
            ('cls_fc_layers', head.CLS_FC, head.SHARED_FC[-1]),
            ('reg_fc_layers', head.REG_FC, head.SHARED_FC[-1])):
        seq = 0
        for i, s in enumerate(sizes):
            put_lin(f'roi_head.{tname}.{seq}', s, cin, bias=False)
            put_bn(f'roi_head.{tname}.{seq + 1}', s)
            cin = s
            seq += 4 if head.DP_RATIO > 0 and i != len(sizes) - 1 else 3
    put_lin('roi_head.cls_pred_layer', 1, head.CLS_FC[-1], True)
    put_lin('roi_head.reg_pred_layer', 7, head.REG_FC[-1], True)
    if 'KLLabel' in head.NAME:
        put_lin('roi_head.reg_std_layer', 7, head.REG_FC[-1], True)
        put_bn('roi_head.reg_std_bn', 7)
        put_lin('roi_head.reg_std_fc1', 64, 7, True)
        put_bn('roi_head.reg_std_bn1', 64)
        put_lin('roi_head.reg_std_fc2', 1, 64, True)
    return sd


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_trees_equal(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert set(got) == set(ref)
    for path, r in ref.items():
        g = got[path]
        assert np.asarray(g).dtype == np.asarray(r).dtype, path
        assert np.shape(g) == np.shape(r), path
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=str(path))


@pytest.fixture(scope='module', params=MODES)
def converted(request):
    from glenet_tpu.utils import weight_converter as jwc

    from glenet_tpu_torch.utils import weight_converter as wc
    cfg = _cfg(request.param)
    variables, port_template, tdet = _template(cfg)
    sd = _pcdet_sd_from_flax(cfg, variables, seed=4)
    ref = jwc.convert_full_model(cfg, sd, variables)
    got = wc.convert_full_model(tp.to_port_cfg(cfg), sd, variables)
    return request.param, cfg, variables, port_template, tdet, sd, ref, got


def test_converters_agree(converted):
    mode, _, _, _, _, sd, (ref, ref_report), (got, report) = converted
    _assert_trees_equal(got, ref)
    assert report == ref_report
    roi_keys = sorted(k for k in sd if k.startswith('roi_head.')
                      and 'num_batches_tracked' not in k)
    if mode == 'corner':
        assert report['unconsumed'] == roi_keys
        assert report['converted'] == ['backbone_3d', 'backbone_2d',
                                       'dense_head']
    else:
        assert report['unconsumed'] == []
        assert report['converted'][-1] == 'roi_head'


def test_port_template_matches_jax(converted):
    """The port's net exported in the JAX layout has the JAX tree's paths,
    shapes and dtypes, and loads back bit-exactly."""
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    _, _, variables, port_template, tdet, _, _, _ = converted
    ref = {p: (np.shape(v), np.asarray(v).dtype)
           for p, v in _leaves(variables)}
    got = {p: (np.shape(v), v.dtype) for p, v in _leaves(port_template)}
    assert got == ref
    before = {k: v.clone() for k, v in tdet.net.state_dict().items()}
    load_jax_variables(tdet.net, port_template)
    for k, v in tdet.net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_predict_on_converted_weights():
    """voxel_query mode, where the roi head converts too: the port's
    converted tree drives both packages' predicts."""
    from glenet_tpu_torch.utils import weight_converter as wc
    cfg = _cfg('voxel_query')
    variables, _, _ = _template(cfg)
    sd = _pcdet_sd_from_flax(cfg, variables, seed=6)
    merged, _ = wc.convert_full_model(tp.to_port_cfg(cfg), sd, variables)
    with tp.pinned_f32():
        _, jax_pred, _, pred, _ = tp.run_predicts(cfg, variables=merged,
                                                  n_points=2048, seed=5)
    tp.assert_predict_equal(pred, jax_pred)


@pytest.mark.parametrize('which', ['toy', 'toy_corner', 'toy_plain',
                                   'GLENet_VR_vq.yaml',
                                   'voxel_rcnn_car.yaml'])
def test_synthetic_pcdet_state_dict(which):
    """The port's writer of reference state dicts names and shapes every
    key as the reference does: JAX's converter consumes all of them (in
    corner mode all but the roi head's) and each converted leaf has the
    template's shape."""
    from glenet_tpu.config import cfg_from_yaml_file
    from glenet_tpu.utils import weight_converter as jwc

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils import synthetic
    from glenet_tpu_torch.utils.jax_weights import port_to_jax_variables
    if which.startswith('toy'):
        cfg = _cfg({'toy': 'voxel_query', 'toy_corner': 'corner',
                    'toy_plain': 'voxel_query_plain'}[which])
    else:
        cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models' / which))
        if which.startswith('voxel_rcnn'):
            tp.voxel_query_cfg(cfg)
    tcfg = tp.to_port_cfg(cfg)
    template = port_to_jax_variables(build_detector(tcfg, device='cpu').net)
    sd = {k: v.numpy() for k, v in
          synthetic.pcdet_state_dict(tcfg, seed=1).items()}
    merged, report = jwc.convert_full_model(cfg, sd, template)
    roi_keys = sorted(k for k in sd if k.startswith('roi_head.')
                      and 'num_batches_tracked' not in k)
    assert report['unconsumed'] == (roi_keys if which == 'toy_corner'
                                    else [])
    shapes = {p: np.shape(v) for p, v in _leaves(template)}
    assert {p: np.shape(v) for p, v in _leaves(merged)} == shapes


def test_convert_weights_cli_then_test(tmp_path):
    """A reference .pth through the port's convert_weights CLI, then its
    checkpoint through `tools.test --ckpt`, on the CPU."""
    from test_torch_train_cli import _write_cfg

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.tools import convert_weights
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.train import checkpoint as ck
    from glenet_tpu_torch.utils import synthetic
    root = synthetic.write_kitti_tree(
        tmp_path / 'kitti', n_train=2, n_val=2, seed=5, n_points=4000,
        cars=(2, 3), x_range=(6.0, 14.0), y_half=6.0, ground_radius=20.0)
    raw = yaml.safe_load(_write_cfg(tmp_path, root).read_text())
    cfg_path = tmp_path / 'toy_glenet_vr_vq.yaml'
    cfg_path.write_text(yaml.safe_dump(json.loads(json.dumps(
        tp.voxel_query_cfg(tp.to_port_cfg(raw))))))
    cfg = cfg_from_yaml_file(str(cfg_path))
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    sd = synthetic.pcdet_state_dict(cfg, seed=3)
    pth = tmp_path / 'pcdet.pth'
    torch.save({'model_state': sd, 'epoch': 7}, pth)
    out = tmp_path / 'out'
    path, report = convert_weights.main([
        '--cfg_file', str(cfg_path), '--torch_ckpt', str(pth),
        '--output_dir', str(out / 'ckpt'), '--device', 'cpu'])
    assert Path(path).name == 'checkpoint_epoch_7.pth'
    assert report['unconsumed'] == []
    state = ck.load_checkpoint(path)['model_state']
    torch.testing.assert_close(
        state['roi_head.pool_x_conv2.mlp_in.weight'],
        sd['roi_head.roi_grid_pool_layers.0.mlps_in.0.0.weight'][:, :, 0],
        rtol=0, atol=0)
    results = test_cli.main(['--cfg_file', str(cfg_path), '--ckpt', path,
                             '--output_dir', str(out), '--device', 'cpu'])
    (got_path, res), = results.items()
    assert got_path == path and res['frames'] == 2
    assert 'Car_3d/moderate_R40' in res['ap']


@pytest.mark.parametrize('name', [
    'centerpoint.yaml', 'centerpoint_without_resnet.yaml',
    'centerpoint_pillar_1x.yaml', 'voxel_rcnn_with_centerhead_dyn_voxel.yaml',
    'pv_rcnn_with_centerhead_rpn.yaml'])
def test_converters_agree_centerhead(name):
    """A synthetic reference state dict (utils/synthetic.pcdet_state_dict)
    of each Waymo config with a CenterHead, at full width, through both
    converters into the port's template: the trees are exactly equal, with
    equal reports (stage 2 of the two-stage configs unconsumed, as
    glenet_tpu leaves it in corner pooling), and the port's net loads the
    result with no leaf left over."""
    from glenet_tpu.config import cfg_from_yaml_file
    from glenet_tpu.utils import weight_converter as jwc

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils import synthetic
    from glenet_tpu_torch.utils import weight_converter as wc
    from glenet_tpu_torch.utils.jax_weights import (load_jax_variables,
                                                    port_to_jax_variables)
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/waymo_models' / name))
    tcfg = tp.to_port_cfg(cfg)
    det = build_detector(tcfg, device='cpu')
    template = port_to_jax_variables(det.net)
    sd = {k: v.numpy() for k, v in
          synthetic.pcdet_state_dict(tcfg, seed=2).items()}
    ref, ref_report = jwc.convert_full_model(cfg, sd, template)
    got, report = wc.convert_full_model(tcfg, sd, template)
    _assert_trees_equal(got, ref)
    assert report == ref_report
    stage2 = sorted(k for k in sd if k.startswith(('roi_head.', 'pfe.',
                                                   'point_head.'))
                    and 'num_batches_tracked' not in k)
    assert report['unconsumed'] == stage2
    assert bool(stage2) == ('rcnn' in name)
    assert report['converted'][-1] == 'dense_head'
    load_jax_variables(det.net, got)
    head = det.net.dense_head
    torch.testing.assert_close(
        head.hm_1.bias, torch.from_numpy(
            sd['dense_head.heads_list.0.hm.1.bias']).float(), rtol=0, atol=0)


@pytest.mark.parametrize('name', ['pv_rcnn_plusplus.yaml',
                                  'pv_rcnn_plusplus_resnet.yaml'])
def test_converters_agree_pvrcnn_plusplus(name):
    """A synthetic reference PV-RCNN++ state dict at full width (its
    VectorPool layers under the reference's names: layer_<k>.
    separate_local_aggregation_layer, post_mlps, msg_post_mlps) through
    both converters: stage 1 converts into equal trees with equal reports,
    and every pfe.*, point_head.* and roi_head.* key is reported
    unconsumed, as glenet_tpu's converter leaves them."""
    from glenet_tpu.config import cfg_from_yaml_file
    from glenet_tpu.utils import weight_converter as jwc

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils import synthetic
    from glenet_tpu_torch.utils import weight_converter as wc
    from glenet_tpu_torch.utils.jax_weights import (load_jax_variables,
                                                    port_to_jax_variables)
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/waymo_models' / name))
    tcfg = tp.to_port_cfg(cfg)
    det = build_detector(tcfg, device='cpu')
    template = port_to_jax_variables(det.net)
    sd = {k: v.numpy() for k, v in
          synthetic.pcdet_state_dict(tcfg, seed=3).items()}
    ref, ref_report = jwc.convert_full_model(cfg, sd, template)
    got, report = wc.convert_full_model(tcfg, sd, template)
    _assert_trees_equal(got, ref)
    assert report == ref_report
    assert report['converted'] == ['backbone_3d', 'backbone_2d',
                                   'dense_head']
    assert report['unconsumed'] == sorted(
        k for k in sd if k.startswith(('pfe.', 'point_head.', 'roi_head.'))
        and 'num_batches_tracked' not in k)
    for key in ('pfe.SA_rawpoints.layer_1.separate_local_aggregation_layer.'
                '0.weight', 'pfe.SA_layers.1.msg_post_mlps.0.weight',
                'roi_head.roi_grid_pool_layer.layer_0.post_mlps.3.weight'):
        assert key in report['unconsumed'], key
    load_jax_variables(det.net, got)


def test_pvrcnn_plusplus_variables_round_trip():
    """glenet_tpu's toy PV-RCNN++ variables (numpy draws for every leaf,
    the VectorPool `separate_w` (G, C_in, D) kernels among them) -> the
    port -> a glenet_tpu tree with the same paths and values."""
    import jax.numpy as jnp
    from __graft_entry__ import _make_batch
    from glenet_tpu.models.detectors import build_detector as jax_build

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import (load_jax_variables,
                                                    port_to_jax_variables)
    cfg = tp.tiny_pvpp_cfg()
    batch = _make_batch(2, n_points=256, seed=3,
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0),
                            jax.tree.map(jnp.asarray, batch))
    variables = tp.random_variables(shapes, seed=4)
    det = build_detector(tp.to_port_cfg(cfg), device='cpu')
    load_jax_variables(det.net, variables)
    back = port_to_jax_variables(det.net)
    ref, got = dict(_leaves(variables)), dict(_leaves(back))
    assert set(got) == set(ref)
    assert sum('separate_w' in p[-1] for p in ref) == 8
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))
