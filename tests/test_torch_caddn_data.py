"""CaDDN's host side in the port against glenet_tpu on the CPU: the camera
items of the KITTI dataset (image_2 / depth_2 PNGs written by the port's
own codec and read by the port without Pillow, by glenet_tpu through
Pillow), calib_to_matricies, the padding to IMAGE_PAD_TO, the block-mean
depth downsample, the 2-D boxes at the feature map's scale, collation,
random_image_flip and noise_per_object under one seed, and the image
shape the prediction dicts project with.  Every comparison is exact: both
packages run the same numpy arithmetic on the same pixels."""
import numpy as np
import pytest

pytest.importorskip('jax')
pytest.importorskip('PIL')

import caddn_parity as cp  # noqa: E402

CAMERA_KEYS = ('images', 'depth_maps', 'trans_lidar_to_cam',
               'trans_cam_to_img', 'image_shape', 'gt_boxes2d',
               'gt_boxes2d_mask')


@pytest.fixture(scope='module')
def camera_tree(tmp_path_factory):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.utils import synthetic
    base = tmp_path_factory.mktemp('caddn_kitti')
    root = synthetic.write_kitti_tree(
        base / 'kitti', n_train=4, n_val=2, seed=3, n_points=6000,
        cars=(2, 3), x_range=(6.0, 14.0), y_half=6.0, ground_radius=20.0,
        camera=True)
    cfg_path = cp.write_toy_caddn_yaml(base / 'toy_caddn.yaml', root)
    cfg = cfg_from_yaml_file(str(cfg_path))
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    synthetic.add_label_variances(root, seed=4)
    return root, cfg_path


def _datasets(cfg_path, training, seed=0):
    from glenet_tpu.config import cfg_from_yaml_file as jax_cfg
    from glenet_tpu.datasets.kitti_dataset import KittiDataset as JaxKitti

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import KittiDataset
    jc, tc = jax_cfg(str(cfg_path)), cfg_from_yaml_file(str(cfg_path))
    return (JaxKitti(jc.DATA_CONFIG, jc.CLASS_NAMES, training=training,
                     seed=seed),
            KittiDataset(tc.DATA_CONFIG, tc.CLASS_NAMES, training=training,
                         seed=seed))


def _assert_items_equal(ref, got):
    arrays = {k for k, v in ref.items() if isinstance(v, np.ndarray)}
    assert arrays == {k for k, v in got.items()
                      if isinstance(v, np.ndarray)}
    for k in arrays:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_synthetic_camera_tree(camera_tree):
    """The tree's PNGs: 375 x 1242 RGB frames and uint16 depth maps of the
    projected points, 0 where none lands, in the infos' image shape."""
    import pickle

    from glenet_tpu_torch.utils import png
    root, _ = camera_tree
    with open(root / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    for info in infos:
        fid = info['point_cloud']['lidar_idx']
        img = png.read_png(root / 'training/image_2' / f'{fid}.png')
        depth = png.read_png(root / 'training/depth_2' / f'{fid}.png')
        assert img.shape == (375, 1242, 3) and img.dtype == np.uint8
        assert depth.shape == (375, 1242) and depth.dtype == np.uint16
        assert tuple(info['image']['image_shape']) == (375, 1242)
        seen = depth > 0
        assert 0.001 < seen.mean() < 0.5      # 6000 points a frame
        assert ((img[..., 1] == 255) == seen).all()


def test_calib_to_matricies(camera_tree):
    from glenet_tpu.datasets.kitti_dataset import \
        calib_to_matricies as jax_calib_to_matricies

    from glenet_tpu_torch.datasets.kitti_dataset import calib_to_matricies
    from glenet_tpu_torch.utils.calibration_kitti import Calibration
    root, _ = camera_tree
    calib = Calibration(str(root / 'training/calib/000000.txt'))
    for got, ref in zip(calib_to_matricies(calib),
                        jax_calib_to_matricies(calib)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    l2c, c2i = calib_to_matricies(calib)
    # the matrices project as the calibration does (which divides by the
    # rectified depth, not by P2's third row)
    pts = np.array([[10.0, 1.0, -0.5], [30.0, -4.0, 0.5]], np.float32)
    cam = (l2c @ np.c_[pts, np.ones(2)].T).T
    img = (c2i @ cam.T).T
    ref, _ = calib.lidar_to_img(pts)
    np.testing.assert_allclose(img[:, :2] / cam[:, 2:3], ref, rtol=1e-5)


@pytest.mark.parametrize('training', [False, True])
def test_camera_items_match_jax(camera_tree, training):
    """Every item of the split, camera items included (padded image and
    image shape, block-mean depth at 94 x 312, the calibration matrices,
    the 2-D boxes / 4 aligned with the class- and range-filtered gts);
    in training with random_image_flip drawn from one seed."""
    _, cfg_path = camera_tree
    jds, tds = _datasets(cfg_path, training)
    assert len(tds) == len(jds) > 0
    for i in range(len(tds)):
        ref, got = jds[i], tds[i]
        _assert_items_equal(ref, got)
        assert got['images'].shape == (376, 1248, 3)
        assert got['depth_maps'].shape == (94, 312)
        assert tuple(got['image_shape']) == (375, 1242)


def test_collate_batch(camera_tree):
    _, cfg_path = camera_tree
    jds, tds = _datasets(cfg_path, training=False)
    ref = jds.collate_batch([jds[0], jds[1]])
    got = tds.collate_batch([tds[0], tds[1]])
    _assert_items_equal(ref, got)
    for k in CAMERA_KEYS:
        assert got[k].shape[0] == 2, k


def test_prediction_dicts_use_the_batch_image_shape(camera_tree):
    """Predictions become KITTI annos through the batch's image_shape (the
    2-D boxes are clipped to it)."""
    _, cfg_path = camera_tree
    jds, tds = _datasets(cfg_path, training=False)
    batch = tds.collate_batch([tds[0], tds[1]])
    batch['image_shape'] = np.array([[375, 1242], [200, 400]], np.int32)
    boxes = np.array([[[8.0, 2.0, -0.9, 3.9, 1.6, 1.5, 0.3],
                       [12.0, -4.0, -0.9, 4.2, 1.7, 1.5, -1.0]]] * 2,
                     np.float32)
    preds = {'final_boxes': boxes,
             'final_scores': np.full((2, 2), 0.5, np.float32),
             'final_labels': np.ones((2, 2), np.int64),
             'final_valid': np.ones((2, 2), bool)}
    ref = jds.generate_prediction_dicts(batch, preds)
    got = tds.generate_prediction_dicts(batch, preds)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g['bbox'], r['bbox'])
    assert got[1]['bbox'][:, 2].max() <= 400
    assert not np.array_equal(got[0]['bbox'], got[1]['bbox'])


def test_camera_batches_exclude_gt_sampling(camera_tree):
    """A box-adding augmentation would leave gt_boxes2d one row per
    original gt: both packages refuse the misaligned item."""
    _, cfg_path = camera_tree
    jds, tds = _datasets(cfg_path, training=False)
    for ds in (jds, tds):
        info = ds.kitti_infos[0]
        d = ds._raw_item(0)
        d['gt_boxes'] = np.concatenate([d['gt_boxes'], d['gt_boxes'][:1]])
        d['gt_names'] = np.concatenate([d['gt_names'], d['gt_names'][:1]])
        d['gt_uncertainty'] = np.concatenate([d['gt_uncertainty'],
                                              d['gt_uncertainty'][:1]])
        assert 'annos' in info
        with pytest.raises(AssertionError, match='gt_sampling'):
            ds.prepare_data(d)


def _flip_inputs(camera_tree):
    from glenet_tpu_torch.utils.calibration_kitti import Calibration
    root, _ = camera_tree
    rng = np.random.RandomState(7)
    gt = np.array([[8.0, 2.0, -0.9, 3.9, 1.6, 1.5, 0.3, 1],
                   [12.0, -4.0, -0.9, 4.2, 1.7, 1.5, -1.0, 1]], np.float32)
    return {'images': rng.rand(375, 1242, 3).astype(np.float32),
            'depth_maps': rng.rand(375, 1242).astype(np.float32) * 40,
            'calib': Calibration(str(root / 'training/calib/000000.txt')),
            'gt_boxes': gt[:, :7],
            'gt_boxes2d': np.array([[100, 150, 300, 250],
                                    [700, 160, 800, 240]], np.float32)}


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_random_image_flip(camera_tree, seed):
    """Both branches of the draw: the image, depth map, boxes (mirrored
    through the calibration, headings negated) and 2-D boxes (mirrored:
    glenet_tpu's documented fix of the reference) as glenet_tpu's."""
    from glenet_tpu.datasets.augmentor import \
        random_image_flip_horizontal as jax_flip

    from glenet_tpu_torch.datasets.augmentor import \
        random_image_flip_horizontal
    base = _flip_inputs(camera_tree)
    ref = jax_flip(dict(base), np.random.RandomState(seed))
    got = random_image_flip_horizontal(dict(base),
                                       np.random.RandomState(seed))
    for k in ('images', 'depth_maps', 'gt_boxes', 'gt_boxes2d'):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    flipped = not np.array_equal(got['images'], base['images'])
    assert flipped == (np.random.RandomState(seed).rand() >= 0.5)
    if flipped:
        np.testing.assert_array_equal(got['gt_boxes2d'][:, 0],
                                      1242 - base['gt_boxes2d'][:, 2])
        np.testing.assert_allclose(got['gt_boxes'][:, 6],
                                   -base['gt_boxes'][:, 6])


@pytest.mark.parametrize('seed', [0, 1])
def test_noise_per_object(seed):
    """The same draws in the same order: boxes and the points inside them
    moved as glenet_tpu moves them, the collision test included (boxes
    close enough that some candidates collide)."""
    from glenet_tpu.datasets import augmentor_utils as jau

    from glenet_tpu_torch.datasets import augmentor_utils as tau
    rng = np.random.RandomState(10 + seed)
    gt = np.array([[8, 0, -1, 3.9, 1.6, 1.5, 0.1],
                   [8, 2.2, -1, 4.0, 1.7, 1.5, -0.2],
                   [14, -3, -1, 4.2, 1.7, 1.6, 1.2],
                   [20, 5, -1, 0.8, 0.6, 1.7, 0.0]], np.float32)
    pts = np.concatenate([
        np.c_[rng.uniform(-0.5, 0.5, (200, 3)) * gt[i, 3:6] + gt[i, :3],
              rng.rand(200)] for i in range(4)]
        + [np.c_[rng.uniform(0, 30, (300, 3)), rng.rand(300)]]
    ).astype(np.float32)
    valid = np.array([True, True, False, True])
    kw = dict(valid_mask=valid, rotation_perturb=[-0.785, 0.785],
              center_noise_std=[1.0, 1.0, 0.5], num_try=100)
    ref = jau.noise_per_object(gt, pts, rng=np.random.RandomState(seed),
                               **kw)
    got = tau.noise_per_object(gt, pts, rng=np.random.RandomState(seed),
                               **kw)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert not np.array_equal(got[0][valid], gt[valid])
    np.testing.assert_array_equal(got[0][2], gt[2])


def test_noise_per_object_in_the_augmentor(tmp_path):
    """DataAugmentor's noise_per_object step (its config keys, the
    gt_boxes_mask) draws as glenet_tpu's."""
    from glenet_tpu.config import Cfg as JaxCfg
    from glenet_tpu.datasets.augmentor import DataAugmentor as JaxAug

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.datasets.augmentor import DataAugmentor
    raw = {'DISABLE_AUG_LIST': ['placeholder'],
           'AUG_CONFIG_LIST': [{'NAME': 'noise_per_object',
                                'GT_LOC_NOISE_STD': [0.5, 0.5, 0.2],
                                'GT_ROTATION_NOISE': [-0.3, 0.3],
                                'NUM_TRY': 20}]}
    rng = np.random.RandomState(3)
    gt = np.array([[8, 0, -1, 3.9, 1.6, 1.5, 0.1],
                   [16, 4, -1, 4.0, 1.7, 1.5, -0.2]], np.float32)
    pts = np.c_[rng.uniform(0, 20, (500, 3)), rng.rand(500)].astype(
        np.float32)
    d = {'gt_boxes': gt, 'points': pts,
         'gt_boxes_mask': np.array([True, False])}
    ref = JaxAug(tmp_path, JaxCfg(raw), ['Car'], seed=5)(dict(d))
    got = DataAugmentor(tmp_path, Cfg(raw), ['Car'], seed=5)(dict(d))
    for k in ('gt_boxes', 'points'):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
