"""The augmentations of pointpillar_newaugs.yaml and
pointpillar_pyramid_aug.yaml in the port against glenet_tpu:

  - each of the seven through `DataAugmentor` alone (its config wrapper
    and its augmentor_utils function), both packages' RandomState seeded
    alike, on a scene of boxes of the three classes with points inside
    them and clutter around: the points, gt_boxes and gt_names equal
    exactly.  random_world_translation runs both as the yaml writes it
    (WORLD_TRANSLATION_RANGE, a uniform draw) and with
    NOISE_TRANSLATE_STD (a normal draw); the pyramid augmentation at the
    yaml's probabilities and at probabilities that make every part act;
  - the world frustum dropout keeps the port's gt_uncertainty row-aligned
    with the boxes it keeps;
  - the first two training batches of each yaml from the port's
    KittiDataset equal glenet_tpu's, field by field, on one synthetic
    three-class tree (utils/synthetic.write_kitti_tree(three_class=True)),
    with gt sampling pasting boxes of every class."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

pytest.importorskip('jax')

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

AUGS = {
    'random_world_translation': {'WORLD_TRANSLATION_RANGE': [-0.2, 0.2],
                                 'ALONG_AXIS_LIST': ['x', 'y', 'z']},
    'random_world_translation_std': {'NOISE_TRANSLATE_STD': 0.3,
                                     'ALONG_AXIS_LIST': ['x', 'y', 'z']},
    'random_local_translation': {'LOCAL_TRANSLATION_RANGE': [0.95, 1.05],
                                 'ALONG_AXIS_LIST': ['x', 'y', 'z']},
    'random_local_rotation': {'LOCAL_ROT_ANGLE': [-0.15707963267,
                                                  0.15707963267]},
    'random_local_scaling': {'LOCAL_SCALE_RANGE': [0.95, 1.05]},
    'random_world_frustum_dropout': {'INTENSITY_RANGE': [0, 0.2],
                                     'DIRECTION': ['top', 'left']},
    'random_local_frustum_dropout': {'INTENSITY_RANGE': [0, 0.2],
                                     'DIRECTION': ['top', 'bottom',
                                                   'left', 'right']},
    'random_local_pyramid_aug': {'DROP_PROB': 0.25, 'SPARSIFY_PROB': 0.05,
                                 'SPARSIFY_MAX_NUM': 50, 'SWAP_PROB': 0.1,
                                 'SWAP_MAX_NUM': 50},
    'random_local_pyramid_aug_every_part': {
        'DROP_PROB': 0.5, 'SPARSIFY_PROB': 0.6, 'SPARSIFY_MAX_NUM': 8,
        'SWAP_PROB': 1.0, 'SWAP_MAX_NUM': 8},
}


def _scene(seed=0, n_boxes=8):
    """Boxes of the three classes apart from each other, 60-300 points
    inside each, 3000 around them; gt_uncertainty row by row."""
    rng = np.random.RandomState(seed)
    sizes = [(3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73)]
    names = np.array(['Car', 'Pedestrian', 'Cyclist'])[np.arange(n_boxes) % 3]
    boxes = np.zeros((n_boxes, 7), np.float32)
    parts = []
    for i in range(n_boxes):
        dims = sizes[i % 3]
        boxes[i] = [8.0 + 6.0 * (i // 2), -6.0 + 12.0 * (i % 2),
                    -1.6 + dims[2] / 2, *dims, rng.uniform(-np.pi, np.pi)]
        k = rng.randint(60, 300)
        local = rng.uniform(-0.5, 0.5, (k, 3)) * dims
        c, s = np.cos(boxes[i, 6]), np.sin(boxes[i, 6])
        xyz = np.stack([local[:, 0] * c - local[:, 1] * s,
                        local[:, 0] * s + local[:, 1] * c, local[:, 2]], 1)
        parts.append(np.concatenate([xyz + boxes[i, :3],
                                     rng.uniform(0, 1, (k, 1))], 1))
    parts.append(np.stack([rng.uniform(0, 40, 3000),
                           rng.uniform(-15, 15, 3000),
                           rng.uniform(-2, 1, 3000),
                           rng.uniform(0, 1, 3000)], 1))
    return {'points': np.concatenate(parts).astype(np.float32),
            'gt_boxes': boxes, 'gt_names': names,
            'gt_uncertainty': rng.uniform(0.01, 0.2, (n_boxes, 7)).astype(
                np.float32),
            'gt_boxes_mask': np.ones(n_boxes, bool)}


def _augmentors(name, seed, **override):
    from glenet_tpu.config import Cfg
    from glenet_tpu.datasets.augmentor import DataAugmentor as JAug

    from glenet_tpu_torch.datasets.augmentor import DataAugmentor
    aug = {'NAME': name.replace('_std', '').replace('_every_part', ''),
           **AUGS[name], **override}
    cfg = Cfg({'DISABLE_AUG_LIST': ['placeholder'], 'AUG_CONFIG_LIST': [aug]})
    classes = ['Car', 'Pedestrian', 'Cyclist']
    ref = JAug(None, cfg, classes, seed=seed)
    got = DataAugmentor(None, tp.to_port_cfg(cfg), classes, seed=seed)
    assert len(ref.queue) == len(got.queue) == 1
    return ref, got


@pytest.mark.parametrize('name', sorted(AUGS))
def test_augmentation_equals_jax(name):
    changed = 0
    for seed in (0, 1, 2):
        ref_aug, aug = _augmentors(name, seed)
        scene = _scene(seed)
        ref = ref_aug(copy.deepcopy(scene))
        got = aug(copy.deepcopy(scene))
        for k in ('points', 'gt_boxes', 'gt_names'):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=(seed, k))
        changed += not (np.array_equal(got['points'], scene['points'])
                        and np.array_equal(got['gt_boxes'],
                                           scene['gt_boxes']))
        # the draws went in the same order: the streams stand alike
        assert ref_aug.rng.randint(1 << 30) == aug.rng.randint(1 << 30)
    assert changed >= 2, 'the augmentation left the scene as it was'


def test_pyramid_parts_all_act():
    """At the every-part probabilities the dropout, the sparsification and
    the swap each change the points (glenet_tpu's functions one by
    one)."""
    from glenet_tpu.datasets import augmentor_utils as jau
    scene = _scene(0)
    cfg = AUGS['random_local_pyramid_aug_every_part']
    rng = np.random.RandomState(0)
    gt, pts = scene['gt_boxes'], scene['points']
    _, p1, pyr = jau.local_pyramid_dropout(gt, pts, cfg['DROP_PROB'], rng)
    _, p2, pyr = jau.local_pyramid_sparsify(gt, p1, cfg['SPARSIFY_PROB'],
                                            cfg['SPARSIFY_MAX_NUM'], rng,
                                            pyramids=pyr)
    _, p3 = jau.local_pyramid_swap(gt, p2, cfg['SWAP_PROB'],
                                   cfg['SWAP_MAX_NUM'], rng, pyramids=pyr)
    assert len(p1) < len(pts) and len(p2) < len(p1)
    assert not np.array_equal(np.sort(p3, 0), np.sort(p2, 0))


def test_world_frustum_keeps_uncertainty_aligned():
    """Boxes beyond the cut (half the scene's width or more) go with their
    names and label variances."""
    for seed in range(6):
        _, aug = _augmentors('random_world_frustum_dropout', seed,
                             INTENSITY_RANGE=[0.5, 0.8], DIRECTION=['left'])
        scene = _scene(seed)
        got = aug(copy.deepcopy(scene))
        if len(got['gt_boxes']) < len(scene['gt_boxes']):
            break
    else:
        pytest.fail('no seed dropped a box')
    keep = np.array([(got['gt_boxes'][:, :2] == b[:2]).all(1).any()
                     for b in scene['gt_boxes']])
    assert len(got['gt_uncertainty']) == len(got['gt_boxes'])
    np.testing.assert_array_equal(got['gt_uncertainty'],
                                  scene['gt_uncertainty'][keep])
    np.testing.assert_array_equal(got['gt_names'], scene['gt_names'][keep])


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """A three-class tree (4 train frames of 20000 points, 6-9 cars each
    and Pedestrians and Cyclists at KITTI's ratios) with its infos and gt
    database, written by the port."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.utils import synthetic
    root = synthetic.write_kitti_tree(
        tmp_path_factory.mktemp('three_class') / 'kitti', n_train=4,
        n_val=1, seed=4, n_points=20000, cars=(6, 9), x_range=(6.0, 45.0),
        y_half=20.0, ground_radius=50.0, three_class=True)
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/'
                                        'pointpillar_newaugs.yaml'))
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    return root


def _yaml_cfg(name, root, tmp_path):
    """The yaml with its data config on `root`, 16384 points per scene."""
    with open(ROOT / 'configs/kitti_models' / name) as f:
        cfg = yaml.safe_load(f)
    cfg['DATA_CONFIG'].update(DATA_PATH=str(root), MAX_POINTS_PER_SCENE=16384)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return path


@pytest.mark.parametrize('name', ['pointpillar_newaugs.yaml',
                                  'pointpillar_pyramid_aug.yaml'])
def test_first_batches_equal_jax(name, tree, tmp_path):
    import pickle

    from glenet_tpu.config import cfg_from_yaml_file as j_cfg
    from glenet_tpu.datasets import build_dataset as j_build

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets import build_dataset
    with open(tree / 'kitti_dbinfos_train.pkl', 'rb') as f:
        db = pickle.load(f)
    assert all(len(db[c]) > 0 for c in ('Car', 'Pedestrian', 'Cyclist'))
    path = _yaml_cfg(name, tree, tmp_path)
    jc, tc = j_cfg(str(path)), cfg_from_yaml_file(str(path))
    ref_ds = j_build(jc.DATA_CONFIG, jc.CLASS_NAMES, training=True, seed=0)
    ds = build_dataset(tc.DATA_CONFIG, tc.CLASS_NAMES, training=True, seed=0)
    ref_it, it = ref_ds.iter_batches(2, seed=0), ds.iter_batches(2, seed=0)
    labels = []
    for _ in range(2):
        ref, got = next(ref_it), next(it)
        assert ref['frame_id'] == got['frame_id']
        for k in ('points', 'points_mask', 'gt_boxes', 'gt_mask',
                  'gt_uncertainty'):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        labels.append(got['gt_boxes'][..., 7][got['gt_mask']])
    assert set(np.concatenate(labels).astype(int)) == {1, 2, 3}
