"""Parity of the port's GLENet-VR predict path with glenet_tpu on the toy
two-stage topology (__graft_entry__._tiny_twostage_cfg with GLENet-VR's
AnchorHeadSingle), same numpy-drawn weights and points, f32 on both sides.
Two cases: the toy grid as it is (a BEV map of depth 1), and KITTI's z
range [-3, 1] m with a smaller voxel budget (depth 2, so the z-outer /
channel-inner HeightCompression fold matters; more budget overflow).

Tolerances: features and head outputs rtol 1e-4 / atol 1e-5 (f32 sums in
another order through ~15 layers); final boxes and scores atol 1e-4;
integer outputs (proposal indices through the boxes, labels, validity)
exact."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

B = 2
CASES = {'toy': dict(n_points=1024, seed=3, z_range=None, max_voxels=512),
         'kitti_z': dict(n_points=2048, seed=5, z_range=(-3.0, 1.0),
                         max_voxels=384)}


@pytest.fixture(scope='module', params=sorted(CASES))
def runs(request):
    import jax.numpy as jnp

    from __graft_entry__ import _make_batch
    from glenet_tpu.models.detectors import build_detector as jax_build
    from glenet_tpu.ops import voxelize as jvox

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables

    case = CASES[request.param]
    cfg = tp.tiny_twostage_cfg(case['max_voxels'])
    if case['z_range']:
        pc = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
        pc[2], pc[5] = case['z_range']
    batch = _make_batch(B, n_points=case['n_points'], seed=case['seed'],
                        pc_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
    with tp.pinned_f32():
        det = jax_build(cfg)
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0), batch)
        batch = {k: batch[k] for k in ('points', 'points_mask')}
        variables = tp.random_variables(shapes, seed=1)

        def stages(m, points, pmask):
            vox = jax.vmap(functools.partial(
                jvox.voxelize, voxel_size=det.voxel_size,
                pc_range=det.pc_range, grid_size=det.grid_size,
                max_voxels=det.max_voxels_test,
                max_points_per_voxel=det.max_points_per_voxel))(points, pmask)
            feats = jax.vmap(lambda v, n: m.vfe(v, n, train=False))(
                vox['voxels'], vox['voxel_num_points'])
            sp = m.backbone_3d(feats, vox['voxel_coords'], vox['voxel_mask'],
                               train=False)
            ms = {k: {f: sp['multi_scale'][k][f]
                      for f in ('features', 'ids', 'mask', 'occ')
                      if f in sp['multi_scale'][k]}
                  for k in sp['multi_scale']}
            bev2 = m.backbone_2d(sp['bev_features'], train=False)
            return {'vox': vox, 'multi_scale': ms, 'bev': sp['bev_features'],
                    'dense_head': m.dense_head(bev2, train=False)}

        @jax.jit
        def run(v, b):
            return {'stages': det.net_eval.apply(
                        v, b['points'], b['points_mask'], method=stages),
                    'full': det.net_eval.apply(
                        v, b['points'], b['points_mask'], train=False),
                    'pred': det.predict(v, b)}

        jax_out = jax.tree.map(np.asarray, run(
            jax.tree.map(jnp.asarray, variables), batch))

        tdet = build_detector(tp.to_port_cfg(cfg), device='cpu')
        load_jax_variables(tdet.net, variables)
        pts = torch.from_numpy(np.array(batch['points']))
        pmask = torch.from_numpy(np.array(batch['points_mask']))
        with torch.no_grad():
            full = tdet.net(pts, pmask)
            pred = tdet.finalize(full)
    return jax_out, full, pred, tdet, variables


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol, atol=atol)


def test_backbone_stages(runs):
    jax_out, full, _, _, _ = runs
    st = jax_out['stages']
    for k in ('voxel_coords', 'voxel_mask', 'voxel_num_points'):
        np.testing.assert_array_equal(full['vox'][k].numpy(), st['vox'][k])
    ms_t = full['backbone_3d']['multi_scale']
    for lvl, fields in st['multi_scale'].items():
        for f, ref in fields.items():
            got = ms_t[lvl][f]
            if f == 'features':
                _close(got, ref)
            else:
                np.testing.assert_array_equal(got.numpy(), ref)
    _close(full['backbone_3d']['bev_features'], st['bev'])
    for k, ref in st['dense_head'].items():
        _close(full['dense_head'][k], ref)


def test_proposals_and_rcnn(runs):
    jax_out, full, _, _, _ = runs
    prop_j, prop_t = jax_out['full']['proposals'], full['proposals']
    np.testing.assert_array_equal(prop_t['roi_valid'].numpy(),
                                  prop_j['roi_valid'])
    np.testing.assert_array_equal(prop_t['roi_labels'].numpy(),
                                  prop_j['roi_labels'])
    _close(prop_t['rois'], prop_j['rois'])
    _close(prop_t['roi_scores'], prop_j['roi_scores'])
    for k in ('rcnn_cls', 'rcnn_reg', 'rcnn_reg_std'):
        _close(full['rcnn'][k], jax_out['full']['rcnn'][k])


def test_predict_end_to_end(runs):
    jax_out, _, pred, _, _ = runs
    ref = jax_out['pred']
    assert ref['final_valid'].any(), 'the case must keep some boxes'
    np.testing.assert_array_equal(pred['final_valid'].numpy(),
                                  ref['final_valid'])
    np.testing.assert_array_equal(pred['final_labels'].numpy(),
                                  ref['final_labels'])
    _close(pred['final_boxes'], ref['final_boxes'], rtol=0, atol=1e-4)
    _close(pred['final_scores'], ref['final_scores'], rtol=0, atol=1e-4)


def test_bridge_sets_every_parameter(runs):
    """Every JAX leaf lands somewhere and every port tensor gets a value;
    a missing leaf or an extra one raises."""
    _, _, _, tdet, variables = runs
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables

    state = tdet.net.state_dict()
    n_leaves = sum(1 for _ in jax.tree_util.tree_leaves(variables))
    assert len(state) == n_leaves
    bn = state['backbone_3d.conv_input.MaskedBatchNorm_0.running_var']
    np.testing.assert_array_equal(
        bn.numpy(), variables['batch_stats']['backbone_3d']['conv_input']
        ['MaskedBatchNorm_0']['var'])
    missing = {c: dict(t) for c, t in variables.items()}
    missing['params'] = {k: v for k, v in missing['params'].items()
                         if k != 'dense_head'}
    with pytest.raises(KeyError, match='not set'):
        load_jax_variables(tdet.net, missing)
    extra = {c: dict(t) for c, t in variables.items()}
    extra['params'] = dict(extra['params'], stray={'kernel': np.zeros(3)})
    with pytest.raises(KeyError, match='no port module'):
        load_jax_variables(tdet.net, extra)
