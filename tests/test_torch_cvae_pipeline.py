"""Parity of the port's CVAE pipeline and analysis
(glenet_tpu_torch/cvae/{pipeline,analysis}.py, ops/iou3d.py::
boxes_aligned_iou3d) with glenet_tpu, and the port's K-fold run and CLIs
end to end on the CPU, on synthetic gt databases
(utils/synthetic.write_crop_database) at the full width of
configs/cvae/exp_gen.yaml with batches of 8.

  - predict_samples with JAX's eps (replayed through cvae.model.draw_eps:
    PRNGKey(seed * 1000 + pass), one split per batch): predictions rtol
    1e-5 (atol 1e-5 times the largest |value|), keys and gt boxes exact;
  - mapping_uncertainty, change_gt_infos, change_gt_infos_waymo: exact;
  - boxes_aligned_iou3d and analyze: 1e-5;
  - run_kfold_pipeline (3 folds, 1 epoch, 3 passes) and both CLIs with
    --device cpu, --inject included."""
import copy
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import yaml

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LATENT, BATCH = 8, 8


def _cfgs(name='exp_gen.yaml'):
    from glenet_tpu.config import cfg_from_yaml_file as jcfg
    from glenet_tpu_torch.config import cfg_from_yaml_file
    path = str(ROOT / 'configs/cvae' / name)
    out = jcfg(path), cfg_from_yaml_file(path)
    for c in out:
        c.OPTIMIZATION.BATCH_SIZE_PER_GPU = BATCH
    return out


@pytest.fixture(scope='module')
def db(tmp_path_factory):
    from glenet_tpu_torch.utils.synthetic import write_crop_database
    root = tmp_path_factory.mktemp('crops')
    return root, write_crop_database(root, 22, 2, seed=3)


@pytest.fixture(scope='module')
def passes(db):
    """JAX's predict_samples over a val fold (2 passes, a short last
    batch) and the port's with JAX's eps."""
    from glenet_tpu.config import Cfg as JCfg
    from glenet_tpu.cvae import dataset as jds
    from glenet_tpu.cvae.model import CVAEGenerator as JGen
    from glenet_tpu.cvae.pipeline import predict_samples as j_predict
    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.cvae import dataset as tds
    from glenet_tpu_torch.cvae import model as tm
    from glenet_tpu_torch.cvae.pipeline import predict_samples
    from glenet_tpu_torch.utils.jax_weights import load_jax_variables
    root, _ = db
    jcfg, cfg = _cfgs()
    data = dict(cfg.DATA_CONFIG, FOLD_IDX=0, NUM_FOLDS=2)
    jd = jds.KittiGtDataset(JCfg(data), training=False, root_path=root)
    td = tds.KittiGtDataset(Cfg(data), training=False, root_path=root)
    assert len(td) % BATCH
    jgen = JGen(latent_dim=LATENT, num_bins=2)
    shapes = jax.eval_shape(lambda: jgen.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 512, 4)), jnp.zeros((2, 8)),
        jax.random.PRNGKey(1)))
    variables = tp.random_variables(shapes, seed=5)
    jd.rng = np.random.RandomState(8)
    ref = j_predict(jgen, variables, jd, jcfg.MODEL, n_passes=2,
                    batch_size=BATCH, seed=3)

    draws = []
    for p in range(2):
        rng = jax.random.PRNGKey(3 * 1000 + p)
        for s in range(0, len(td), BATCH):
            rng, r = jax.random.split(rng)
            n = min(BATCH, len(td) - s)
            draws.append(np.array(jax.random.normal(r, (n, LATENT))))
    it = iter(draws)

    def draw(shape, generator, device):
        e = next(it)
        assert tuple(shape) == e.shape
        return torch.from_numpy(e).to(device)

    gen = tm.CVAEGenerator(latent_dim=LATENT, num_bins=2)
    load_jax_variables(gen, variables)
    td.rng = np.random.RandomState(8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, 'draw_eps', draw)
        got = predict_samples(gen, td, cfg.MODEL, n_passes=2,
                              batch_size=BATCH, seed=3)
    assert next(it, None) is None
    return ref, got


def test_predict_samples(passes):
    ref, got = passes
    assert len(got) == 2
    preds = np.stack([[v['pred_box'] for v in r.values()] for r in ref])
    for r, g in zip(ref, got):
        assert list(r) == list(g)
        for key in r:
            np.testing.assert_array_equal(g[key]['gt_box'], r[key]['gt_box'])
            np.testing.assert_allclose(
                g[key]['pred_box'], r[key]['pred_box'], rtol=1e-5,
                atol=1e-5 * np.abs(preds).max(), err_msg=key)


def test_mapping_uncertainty(passes):
    from glenet_tpu.cvae.pipeline import mapping_uncertainty as j_map
    from glenet_tpu_torch.cvae.pipeline import mapping_uncertainty
    ref, _ = passes
    want, got = j_map(ref), mapping_uncertainty(ref)
    assert list(want) == list(got)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _kitti_infos(db_dict):
    """Infos of the frames of a crop database: its objects in gt_idx
    order, plus a Pedestrian and a DontCare (index -1)."""
    frames = {}
    for infos in db_dict.values():
        for info in infos:
            frames.setdefault(info['image_idx'], {})[info['gt_idx']] = info
    out = []
    for fid, objs in sorted(frames.items()):
        names = [objs[i]['name'] for i in sorted(objs)]
        out.append({'image': {'image_idx': fid}, 'annos': {
            'name': np.array(names + ['Pedestrian', 'DontCare']),
            'index': np.array(list(range(len(names) + 1)) + [-1])}})
    return out


def test_change_gt_infos(db):
    from glenet_tpu.cvae.pipeline import change_gt_infos as j_change
    from glenet_tpu_torch.cvae.pipeline import change_gt_infos
    _, db_dict = db
    rng = np.random.RandomState(0)
    unc = {f"{i['image_idx']}_{i['gt_idx']}": rng.uniform(0, 0.1, 7)
           for i in db_dict['Car']}
    infos = [i for i in _kitti_infos(db_dict)
             if set(i['annos']['name'][:-2]) == {'Car'}]
    want = j_change(unc, copy.deepcopy(infos), copy.deepcopy(db_dict))
    got = change_gt_infos(unc, copy.deepcopy(infos), copy.deepcopy(db_dict))
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(g['annos']['uncertainty'],
                                      w['annos']['uncertainty'])
        assert (g['annos']['uncertainty'][-2:] == -1).all()
    for w, g in zip(want[1]['Car'], got[1]['Car']):
        np.testing.assert_array_equal(g['uncertainty'], w['uncertainty'])
    assert all('uncertainty' not in i for i in got[1]['Van'])


def test_change_gt_infos_waymo():
    from glenet_tpu.cvae.pipeline import change_gt_infos_waymo as j_change
    from glenet_tpu_torch.cvae.pipeline import change_gt_infos_waymo
    rng = np.random.RandomState(1)
    infos, db_dict, unc = [], {'Vehicle': []}, {}
    for f in range(4):
        names = np.array(['Vehicle', 'Pedestrian', 'Vehicle'][:3 - (f == 3)])
        infos.append({'point_cloud': {'lidar_sequence': f'seq_{f // 2}',
                                      'sample_idx': f % 2},
                      'annos': {'name': names}})
        for i, n in enumerate(names):
            if n == 'Vehicle':
                unc[f'seq_{f // 2}#{f % 2}_{i}'] = rng.uniform(0, 0.1, 7)
                db_dict['Vehicle'].append({'sequence_name': f'seq_{f // 2}',
                                           'sample_idx': f % 2, 'gt_idx': i})
    infos.append({'point_cloud': {'lidar_sequence': 'seq_9',
                                  'sample_idx': 0},
                  'annos': {'name': np.array([], dtype='<U8')}})
    want = j_change(unc, copy.deepcopy(infos), copy.deepcopy(db_dict))
    got = change_gt_infos_waymo(unc, copy.deepcopy(infos),
                                copy.deepcopy(db_dict))
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(g['annos']['uncertainty'],
                                      w['annos']['uncertainty'])
    assert got[0][-1]['annos']['uncertainty'].shape == (0, 7)
    for w, g in zip(want[1]['Vehicle'], got[1]['Vehicle']):
        np.testing.assert_array_equal(g['uncertainty'], w['uncertainty'])


def _boxes(seed, n):
    rng = np.random.RandomState(seed)
    a = np.concatenate([rng.uniform(-5, 5, (n, 3)), rng.uniform(1, 4, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    b = a + rng.normal(0, 0.5, a.shape) * [1, 1, 1, 0.2, 0.2, 0.2, 1]
    b[:4] = a[:4]                               # identical pairs
    b[4:8, 0] += 30                             # disjoint pairs
    b[8:12, 6] = a[8:12, 6] + np.pi / 2         # crossed
    return a.astype(np.float32), b.astype(np.float32)


def test_boxes_aligned_iou3d():
    from glenet_tpu.ops.iou3d import boxes_aligned_iou3d as j_iou
    from glenet_tpu_torch.ops.iou3d import boxes_aligned_iou3d
    a, b = _boxes(0, 300)
    want = np.asarray(j_iou(jnp.asarray(a), jnp.asarray(b)))
    got = boxes_aligned_iou3d(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[:4], 1.0, rtol=1e-5)
    assert (got.numpy()[4:8] == 0).all()


def test_analyze(passes):
    """The report on the JAX passes (normalised boxes), and on passes
    of boxes at metric scale around two gt boxes, one tight and one
    loose, with point counts."""
    from glenet_tpu.cvae.analysis import analyze as j_analyze
    from glenet_tpu_torch.cvae.analysis import analyze
    ref, _ = passes
    rng = np.random.RandomState(0)
    gts = {'000_0': np.array([10., 0., -1., 3.9, 1.6, 1.56, 0.3]),
           '000_1': np.array([20., 5., -1., 3.9, 1.6, 1.56, -0.5])}
    metric = [{k: {'pred_box': g + rng.normal(0, s, 7), 'gt_box': g}
               for (k, g), s in zip(gts.items(), (0.02, 0.5))}
              for _ in range(8)]
    counts = {'000_0': 500, '000_1': 12}
    for per_pass, pc in ((ref, None), (metric, counts)):
        want = j_analyze(per_pass, point_counts=pc)
        got = analyze(per_pass, point_counts=pc, device='cpu')
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert got['corr_variance_iou'] < 0


def test_run_kfold_pipeline(db, tmp_path):
    """3 folds x 1 epoch x 3 passes: one finite, non-negative 7-vector
    per object of the database, written to un_v4.pkl."""
    from glenet_tpu_torch.cvae.pipeline import run_kfold_pipeline
    root, db_dict = db
    _, cfg = _cfgs()
    unc = run_kfold_pipeline(cfg, root, n_folds=3, n_passes=3, seed=0,
                             num_epochs=1, output_dir=tmp_path / 'out',
                             device='cpu')
    want = {f"{i['image_idx']}_{i['gt_idx']}"
            for v in db_dict.values() for i in v}
    assert set(unc) == want
    for v in unc.values():
        assert v.shape == (7,) and np.isfinite(v).all() and (v >= 0).all()
    assert any(v.max() > 0 for v in unc.values())
    with open(tmp_path / 'out' / 'un_v4.pkl', 'rb') as f:
        saved = pickle.load(f)
    assert set(saved) == want
    assert all(np.array_equal(saved[k], unc[k]) for k in want)


def test_set_wconf_paths():
    """The --set pairs that point GLENet-VR's training at the injected
    infos and gt database."""
    from glenet_tpu_torch.config import cfg_from_list, cfg_from_yaml_file
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    cfg_from_list(['DATA_CONFIG.INFO_PATH.train',
                   'kitti_infos_train_wconf.pkl',
                   'DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST:0.DB_INFO_PATH',
                   'kitti_dbinfos_train_wconf.pkl'], cfg)
    assert cfg.DATA_CONFIG.INFO_PATH.train == ['kitti_infos_train_wconf.pkl']
    sampler = cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST[0]
    assert sampler.NAME == 'gt_sampling'
    assert sampler.DB_INFO_PATH == ['kitti_dbinfos_train_wconf.pkl']
    with pytest.raises(KeyError):
        cfg_from_list(['DATA_CONFIG.NOPE:0.X', '1'], cfg)


def test_clis(db, tmp_path):
    """cvae_train --inject on the CPU writes un_v4.pkl and the _wconf
    infos and gt database; cvae_analysis reports on pickled passes as the
    JAX analysis does."""
    from glenet_tpu.cvae.analysis import analyze as j_analyze
    from glenet_tpu_torch.cvae import dataset as tds
    from glenet_tpu_torch.cvae.pipeline import build_generator, predict_samples
    from glenet_tpu_torch.tools import cvae_analysis, cvae_train
    root, db_dict = db
    _, cfg = _cfgs()
    cfg_file = tmp_path / 'cvae.yaml'
    cfg_file.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    infos = _kitti_infos(db_dict)
    with open(root / 'kitti_infos_train.pkl', 'wb') as f:
        pickle.dump(infos, f)
    out = tmp_path / 'dump'
    unc = cvae_train.main(['--cfg_file', str(cfg_file), '--data_path',
                           str(root), '--folds', '2', '--passes', '2',
                           '--epochs', '1', '--output_dir', str(out),
                           '--inject', '--device', 'cpu'])
    assert len(unc) == 24 and (out / 'un_v4.pkl').exists()
    with open(root / 'kitti_infos_train_wconf.pkl', 'rb') as f:
        wconf = pickle.load(f)
    with open(root / 'kitti_dbinfos_train_wconf.pkl', 'rb') as f:
        wdb = pickle.load(f)
    for info in wconf:
        annos = info['annos']
        u = annos['uncertainty']
        assert u.shape == (len(annos['name']), 7)
        cars = annos['name'] == 'Car'
        assert (u[~cars] == -1).all() and (u[cars] >= 0).all()
    assert all(np.array_equal(i['uncertainty'],
                              unc[f"{i['image_idx']}_{i['gt_idx']}"])
               for i in wdb['Car'])

    ds = tds.KittiGtDataset(cfg.DATA_CONFIG, training=False, root_path=root)
    per_pass = predict_samples(build_generator(cfg.MODEL, 'cpu'), ds,
                               cfg.MODEL, n_passes=3, batch_size=BATCH)
    path = tmp_path / 'passes.pkl'
    with open(path, 'wb') as f:
        pickle.dump(per_pass, f)
    report = cvae_analysis.main(['--device', 'cpu', str(path)])
    want = j_analyze(per_pass)
    for k in want:
        np.testing.assert_allclose(report[k], want[k], rtol=1e-5, atol=1e-5)
