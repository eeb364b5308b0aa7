"""Shared helpers of the nuScenes / Lyft / Pandaset parity tests
(tests/test_torch_{nuscenes, lyft_pandaset, nuscenes_centerpoint}.py):
toy trees written by glenet_tpu_torch.utils.synthetic, dataset configs over
them for both packages, toy run-time configs of the card paths, and
batches drawn through the datasets."""
from __future__ import annotations

import copy

import numpy as np

# write_nuscenes_tree's tiny trees: distances scaled into +-9.6 m
SCALE = 0.15
TOY_RANGE = [-9.6, -9.6, -5.0, 9.6, 9.6, 3.0]
LYFT_TOY_CLASSES = ('car', 'pedestrian', 'bicycle')


def nusc_tree(root, lyft=False, seed=1, n_train=4, n_val=3):
    """A tiny nuScenes (or Lyft) tree: sweeps of 600 points, 4 to 8 boxes
    a frame (Lyft: of car, pedestrian and bicycle alone, so each class
    has gts), distances scaled by SCALE."""
    from glenet_tpu_torch.utils import synthetic as syn
    classes = None
    if lyft:
        classes = {c: syn.LYFT_CLASSES[c] for c in LYFT_TOY_CLASSES}
    return syn.write_nuscenes_tree(root, n_train, n_val, seed=seed,
                                   n_points=600, scale=SCALE, boxes=(4, 8),
                                   lyft=lyft, classes=classes)


def pandaset_tree(root, seed=1, n_train=4, n_val=3):
    from glenet_tpu_torch.utils import synthetic as syn
    return syn.write_pandaset_tree(root, n_train, n_val, seed=seed,
                                   n_points=4000, scale=SCALE, boxes=(4, 8))


def data_dict(name, root, augment=True, max_points=4096, max_gt=32):
    """The DATA_CONFIG of run-time config `name` over the tree at `root`,
    toy budgets: MAX_POINTS_PER_SCENE, MAX_GT_PER_SCENE, 512 voxels, the
    toy range; gt sampling of at least 2 points (the crops are small)."""
    from glenet_tpu_torch.config import run_cfg_dict
    data = run_cfg_dict(name)['DATA_CONFIG']
    data.update(DATA_PATH=str(root), MAX_POINTS_PER_SCENE=max_points,
                MAX_GT_PER_SCENE=max_gt, POINT_CLOUD_RANGE=list(TOY_RANGE))
    data['DATA_PROCESSOR'][-1]['MAX_NUMBER_OF_VOXELS'] = {'train': 512,
                                                         'test': 512}
    if augment:
        sampling = data['DATA_AUGMENTOR']['AUG_CONFIG_LIST'][0]
        sampling['PREPARE']['filter_by_min_points'] = [
            f'{c.split(":")[0]}:2'
            for c in sampling['PREPARE']['filter_by_min_points']]
    else:
        del data['DATA_AUGMENTOR']
    return data


def dataset_pair(data, class_names, training, seed=7):
    """glenet_tpu's and the port's dataset over one data dict, both
    datasets' (and augmentors') RandomStates set to one seeded state."""
    from glenet_tpu.config import Cfg as JCfg
    from glenet_tpu.datasets import build_dataset as jbuild

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.datasets import build_dataset
    pair = []
    for build, cfg in ((jbuild, JCfg), (build_dataset, Cfg)):
        ds = build(cfg(copy.deepcopy(data)), class_names, training=training)
        ds.rng = np.random.RandomState(seed)
        if ds.augmentor is not None:
            rng = np.random.RandomState(seed + 1)
            ds.augmentor.rng = rng
            for aug in ds.augmentor.queue:
                if hasattr(aug, 'rng'):
                    aug.rng = rng
        pair.append(ds)
    return pair


def toy_cfg(name, root):
    """A toy version of run-time config `name` for both packages (a
    glenet_tpu Cfg): the toy range (a 192 x 192 x 40 grid), 512 voxels, a
    2D backbone of 2 + 2 layers of 32 / 64 filters, NMS 256 / 64, the toy
    optimizer, a 16-channel shared conv (CenterHead and AnchorHeadMulti),
    the data config of data_dict without augmentation over `root`."""
    from glenet_tpu.config import Cfg

    import torch_parity as tp
    from glenet_tpu_torch.config import run_cfg_dict
    raw = run_cfg_dict(name)
    raw['DATA_CONFIG'] = data_dict(name, root, augment=False)
    m = raw['MODEL']
    m['BACKBONE_2D'] = {
        'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [2, 2],
        'LAYER_STRIDES': [1, 2], 'NUM_FILTERS': [32, 64],
        'UPSAMPLE_STRIDES': [1, 2], 'NUM_UPSAMPLE_FILTERS': [32, 32]}
    head = m['DENSE_HEAD']
    if head['NAME'] == 'CenterHead':
        head['SHARED_CONV_CHANNEL'] = 16
    else:
        head['SHARED_CONV_NUM_FILTER'] = 16
    nms = m['POST_PROCESSING']['NMS_CONFIG']
    nms.update(NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=64)
    raw['OPTIMIZATION'] = dict(tp.TINY_OPTIMIZATION)
    return Cfg(raw)


def tree_batch(cfg, root, batch_size=2, seed=0):
    """The first `batch_size` val frames of the tree through glenet_tpu's
    dataset (no augmentation; every port item equals it, test_torch_
    nuscenes.py holds that), collated: numpy points, masks, gt boxes with
    their classes, and label variances in [0.02, 0.3) (the items' -1 would
    do for these losses, which do not read them).  The dataset draws each
    frame's sweeps at test time too, from its RandomState: `seed` fixes
    it, so the batch is the same in every run."""
    from glenet_tpu.datasets import build_dataset
    ds = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False,
                       seed=seed)
    items = [ds[i] for i in range(batch_size)]
    batch = {k: np.stack([it[k] for it in items])
             for k in ('points', 'points_mask', 'gt_boxes', 'gt_mask')}
    rng = np.random.RandomState(5)
    batch['gt_uncertainty'] = rng.uniform(
        0.02, 0.3, batch['gt_boxes'].shape[:2] + (7,)).astype(np.float32)
    return batch
