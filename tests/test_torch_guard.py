"""Guards of the port: glenet_tpu_torch and chip_smoke.py import neither
JAX nor glenet_tpu nor scikit-learn (the machine with the card has none of
them) nor the repository's root tools (nor the bare convergence_ap,
convergence_waymo and stage2_recovery those import through sys.path), the
port never quietly defaults to the CPU, and what
is not ported yet (datasets, options, CLI flags) raises
NotImplementedError naming itself; CaDDN, its camera items and its
augmentations build and load."""
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip('jax')

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import glenet_tpu_torch
for m in pkgutil.walk_packages(glenet_tpu_torch.__path__, 'glenet_tpu_torch.'):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'glenet_tpu', 'sklearn', 'tools',
                                    'convergence_ap', 'convergence_waymo',
                                    'stage2_recovery'))
print('BAD', bad)
print('PARALLEL', sorted(m for m in sys.modules
                         if m.startswith('glenet_tpu_torch.parallel')))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, '-c', _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert 'BAD []' in out.stdout, out.stdout
    assert ("PARALLEL ['glenet_tpu_torch.parallel', "
            "'glenet_tpu_torch.parallel.distributed', "
            "'glenet_tpu_torch.parallel.mesh']") in out.stdout, out.stdout


def test_build_detector_needs_a_device():
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector

    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    if torch.cuda.is_available():
        assert build_detector(cfg).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_detector(cfg)


@pytest.mark.parametrize('name,ddn', [
    ('CaDDN.yaml', 'DDNLite'), ('CaDDN_deeplab.yaml', 'DDNDeepLabV3')])
def test_caddn_builds(name, ddn):
    """CaDDN, with either depth network, builds on the CPU when asked (the
    camera path: ImageVFE, Conv2DCollapse over the 280 x 376 x 25 grid);
    without a card the default raises."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector

    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models' / name))
    det = build_detector(cfg, device='cpu')
    assert det.net.camera and type(det.net.vfe.ddn).__name__ == ddn
    assert det.net.map_to_bev.ConvBlock_0.Conv_0.weight.shape == (
        64, 25 * 64, 1, 1)
    if torch.cuda.is_available():
        assert build_detector(cfg).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_detector(cfg)


@pytest.mark.parametrize('name', ['second_multihead.yaml', 'second_iou.yaml',
                                  'pointpillar.yaml', 'pv_rcnn.yaml',
                                  'PartA2.yaml', 'PartA2_free.yaml',
                                  '../waymo_models/PartA2.yaml',
                                  'pointrcnn.yaml', 'pointrcnn_iou.yaml',
                                  '../waymo_models/centerpoint.yaml',
                                  '../waymo_models/centerpoint_without_'
                                  'resnet.yaml',
                                  '../waymo_models/centerpoint_pillar_1x.yaml',
                                  '../waymo_models/centerpoint_dyn_pillar_'
                                  '1x.yaml',
                                  '../waymo_models/voxel_rcnn_with_centerhead_'
                                  'dyn_voxel.yaml',
                                  '../waymo_models/pv_rcnn_with_centerhead_'
                                  'rpn.yaml'])
def test_three_class_families_need_a_card(name):
    """KITTI's three-class families (PV-RCNN, PartA2 and PartA2-free too),
    Waymo's PartA2 and the six Waymo configs with a CenterHead build on the
    GPU by default and on the CPU when asked; without a card the default
    raises."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector

    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models' / name))
    assert build_detector(cfg, device='cpu').device.type == 'cpu'
    if torch.cuda.is_available():
        assert build_detector(cfg).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_detector(cfg)


@pytest.mark.parametrize('section,key,value', [
    ('ROI_HEAD.TARGET_CONFIG', 'CLS_SCORE_TYPE', 'raw_roi_iou'),
    ('ROI_HEAD.ROI_GRID_POOL', 'POOL_MODE', 'ball_query')])
def test_unported_options_raise(section, key, value):
    """Options of the ported modules that no ported config sets (the
    reference's raw_roi_iou labels; ball-query RoI pooling) are refused,
    not computed some other way."""
    import torch_parity as tp

    from glenet_tpu_torch.models.detectors import build_detector

    cfg = tp.to_port_cfg(tp.tiny_twostage_cfg())
    node = cfg.MODEL
    for part in section.split('.'):
        node = node[part]
    node[key] = value
    with pytest.raises(NotImplementedError, match=key):
        build_detector(cfg, device='cpu')


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises."""
    from glenet_tpu_torch.ops import merge_kernel as mk

    ids = torch.zeros((1, 8), dtype=torch.int32, device='meta')
    q = torch.zeros((1, 1, 4), dtype=torch.int32, device='meta')
    monkeypatch.setattr(mk, 'resolve_sorted_queries_plain',
                        lambda *a: pytest.fail('fell back to the plain path'))
    with pytest.raises(ValueError, match='unsupported device'):
        mk.resolve_sorted_queries(ids, q)


@pytest.mark.parametrize('cli', ['train', 'test', 'demo'])
def test_clis_need_a_card(cli, tmp_path):
    """The train, test and demo CLIs run on the GPU unless --device cpu is
    given; importing them runs nothing, and without a card they raise
    before they write anything."""
    import importlib
    mod = importlib.import_module(f'glenet_tpu_torch.tools.{cli}')
    argv = ['--cfg_file', str(ROOT / 'configs/kitti_models/GLENet_VR.yaml')]
    argv += (['--data_path', str(tmp_path), '--output',
              str(tmp_path / 'dets.jsonl'), '--html_dir', str(tmp_path / 'h')]
             if cli == 'demo' else ['--output_dir', str(tmp_path)])
    if torch.cuda.is_available():
        assert mod.parse_config(argv)[0].device == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            mod.main(argv)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize('name', ['CaDDN.yaml', 'CaDDN_deeplab.yaml'])
def test_demo_refuses_camera_configs(name, tmp_path):
    """The demo runs on .bin scans, which carry no image: a CaDDN config
    raises naming it before the detector is built or a file written."""
    from glenet_tpu_torch.tools import demo
    with pytest.raises(NotImplementedError, match='CaDDN'):
        demo.main(['--cfg_file', str(ROOT / 'configs/kitti_models' / name),
                   '--data_path', str(tmp_path), '--output',
                   str(tmp_path / 'dets.jsonl'), '--device', 'cpu'])
    assert not any(tmp_path.iterdir())


def _cvae_entry_points(tmp_path):
    """name -> a call of each CVAE entry point with its default device."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.cvae import analysis, pipeline
    from glenet_tpu_torch.tools import cvae_analysis, cvae_train
    cfg_file = str(ROOT / 'configs/cvae/exp_gen.yaml')
    cfg = cfg_from_yaml_file(cfg_file)
    box = np.zeros(7, np.float32)
    passes = [{'0_0': {'pred_box': box, 'gt_box': box}}]
    path = tmp_path / 'passes.pkl'
    with open(path, 'wb') as f:
        pickle.dump(passes, f)
    return {
        'build_generator': lambda: pipeline.build_generator(cfg.MODEL),
        'train_cvae': lambda: pipeline.train_cvae(cfg, dataset=None),
        'run_kfold_pipeline': lambda: pipeline.run_kfold_pipeline(
            cfg, tmp_path, output_dir=tmp_path / 'out'),
        'analyze': lambda: analysis.analyze(passes),
        'cvae_train': lambda: cvae_train.main(
            ['--cfg_file', cfg_file, '--data_path', str(tmp_path),
             '--output_dir', str(tmp_path / 'out')]),
        'cvae_analysis': lambda: cvae_analysis.main([str(path)]),
    }


@pytest.mark.parametrize('name', ['build_generator', 'train_cvae',
                                  'run_kfold_pipeline', 'analyze',
                                  'cvae_train', 'cvae_analysis'])
def test_cvae_entry_points_need_a_card(name, tmp_path):
    """The CVAE's builders, pipeline, analysis and CLIs run on the GPU
    unless given the CPU; without a card they raise before they read or
    write anything."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: nothing to refuse')
    call = _cvae_entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match='no CUDA device'):
        call()
    assert not (tmp_path / 'out').exists()


@pytest.mark.parametrize('flag', ['--workers', '--coordinator_address'])
def test_train_cli_refuses_multi_host_flags(flag, tmp_path):
    """--workers is not ported; --coordinator_address with no peer to meet
    raises once --dist_timeout runs out rather than training alone."""
    import time

    import torch.distributed as dist

    from glenet_tpu_torch.tools import train
    from torch_dist import free_port
    argv = ['--cfg_file', str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'),
            '--output_dir', str(tmp_path), '--device', 'cpu']
    if flag == '--workers':
        with pytest.raises(NotImplementedError, match=flag):
            train.main(argv + [flag, '2'])
        return
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match='(?i)timed out'):
        train.main(argv + [flag, f'127.0.0.1:{free_port()}',
                           '--num_processes', '2', '--process_id', '0',
                           '--dist_timeout', '3'])
    assert time.perf_counter() - t0 < 60
    assert not dist.is_initialized()
    assert not (tmp_path / 'ckpt').exists()


@pytest.mark.parametrize('name', ['random_image_flip', 'noise_per_object'])
def test_camera_augmentations_queue(name, tmp_path):
    """CaDDN.yaml's random_image_flip and noise_per_object build into the
    queue (their draws are held against glenet_tpu in
    test_torch_caddn_data.py); a disabled name is skipped, as in the JAX
    package; an unknown name still raises naming itself."""
    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.datasets.augmentor import DataAugmentor
    cfg = Cfg({'DISABLE_AUG_LIST': ['placeholder'],
               'AUG_CONFIG_LIST': [{'NAME': name,
                                    'ALONG_AXIS_LIST': ['horizontal']},
                                   {'NAME': 'random_world_flip',
                                    'ALONG_AXIS_LIST': ['x']}]})
    assert len(DataAugmentor(tmp_path, cfg, ['Car']).queue) == 2
    cfg.DISABLE_AUG_LIST = [name]
    assert len(DataAugmentor(tmp_path, cfg, ['Car']).queue) == 1
    cfg.AUG_CONFIG_LIST[0]['NAME'] = f'{name}_v2'
    with pytest.raises(NotImplementedError, match=f'{name}_v2'):
        DataAugmentor(tmp_path, cfg, ['Car'])


@pytest.mark.parametrize('name', ['random_world_translation',
                                  'random_local_translation',
                                  'random_local_rotation',
                                  'random_local_scaling',
                                  'random_world_frustum_dropout',
                                  'random_local_frustum_dropout',
                                  'random_local_pyramid_aug'])
def test_ported_augmentations_build(name, tmp_path):
    """The augmentations of pointpillar_newaugs.yaml and
    pointpillar_pyramid_aug.yaml each build into the queue (their values
    are held against glenet_tpu in test_torch_augmentations.py)."""
    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.datasets.augmentor import DataAugmentor
    cfg = Cfg({'DISABLE_AUG_LIST': ['placeholder'],
               'AUG_CONFIG_LIST': [{'NAME': name},
                                   {'NAME': 'random_world_flip',
                                    'ALONG_AXIS_LIST': ['x']}]})
    assert len(DataAugmentor(tmp_path, cfg, ['Car']).queue) == 2


@pytest.mark.parametrize('section,key,value,match', [
    ('', 'NAME', 'PVRCNNPlusPlus', 'PVRCNNPlusPlus'),
    ('', 'NAME', 'PVRCNN', 'PVRCNN'),
    ('POST_PROCESSING.NMS_CONFIG', 'NMS_TYPE', 'soft_nms', 'soft_nms')])
def test_single_stage_refusals(section, key, value, match):
    """What the JAX package has around the single-stage family and the
    port does not (PV-RCNN++, PV-RCNN without its PFE, soft-NMS) raises
    naming itself, at build time or at the first predict."""
    import torch_parity as tp

    from glenet_tpu_torch.models.detectors import build_detector

    cfg = tp.to_port_cfg(tp.tiny_single_stage_cfg('SECOND'))
    node = cfg.MODEL
    for part in filter(None, section.split('.')):
        node = node[part]
    node[key] = value
    with pytest.raises(NotImplementedError, match=match):
        det = build_detector(cfg, device='cpu')
        pts = torch.zeros((1, 16, 4))
        det.predict({'points': pts,
                     'points_mask': torch.ones((1, 16), dtype=torch.bool)})


@pytest.mark.parametrize('name', ['NuScenesDataset', 'LyftDataset',
                                  'PandasetDataset'])
def test_unported_datasets_raise(name, tmp_path):
    """The three datasets that once raised here are ported: build_dataset
    returns each adapter (an empty one over a directory without infos), and
    an unknown name raises naming itself."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets import build_dataset
    base = {'NuScenesDataset': 'nuscenes', 'LyftDataset': 'lyft',
            'PandasetDataset': 'pandaset'}[name]
    cfg = cfg_from_yaml_file(str(
        ROOT / f'configs/dataset_configs/{base}_dataset.yaml'))
    assert cfg.DATASET == name
    ds = build_dataset(cfg, ['car'], training=False, root_path=tmp_path)
    assert type(ds).__name__ == name and len(ds) == 0
    assert ds.METRIC == {'NuScenesDataset': 'nuScenes',
                         'LyftDataset': 'Lyft',
                         'PandasetDataset': 'KITTI'}[name]
    cfg.DATASET = name + 'X'
    with pytest.raises(NotImplementedError, match=name + 'X'):
        build_dataset(cfg, ['car'], training=False, root_path=tmp_path)


_CAMERA_ITEM_KEYS = {'images': ('images', 'image_shape'),
                     'depth_maps': ('depth_maps',),
                     'calib_matricies': ('trans_lidar_to_cam',
                                         'trans_cam_to_img'),
                     'gt_boxes2d': ('gt_boxes2d', 'gt_boxes2d_mask')}


@pytest.fixture(scope='module')
def camera_tree(tmp_path_factory):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.utils import synthetic
    root = synthetic.write_kitti_tree(
        tmp_path_factory.mktemp('guard_camera') / 'kitti', 2, 1, seed=3,
        n_points=4000, cars=(2, 3), x_range=(6.0, 14.0), y_half=6.0,
        ground_radius=20.0, camera=True)
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    create_kitti_infos(cfg.DATA_CONFIG, ['Car'], root, root)
    return root


@pytest.mark.parametrize('item', ['images', 'depth_maps', 'calib_matricies',
                                  'gt_boxes2d'])
def test_camera_items_load(item, camera_tree):
    """Each camera item of GET_ITEM_LIST loads on its own from a tree with
    image_2 / depth_2 PNGs, and adds only its own keys; an unknown item
    still raises naming itself."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import KittiDataset
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    cfg.DATA_CONFIG.GET_ITEM_LIST = ['points', item]
    ds = KittiDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False,
                      root_path=camera_tree)
    keys = {k for ks in _CAMERA_ITEM_KEYS.values() for k in ks}
    assert set(ds[0]) & keys == set(_CAMERA_ITEM_KEYS[item])
    cfg.DATA_CONFIG.GET_ITEM_LIST = ['points', f'{item}_v2']
    with pytest.raises(NotImplementedError, match=f'{item}_v2'):
        KittiDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False,
                     root_path=camera_tree)


@pytest.mark.parametrize('section,name', [
    ('VFE', 'DynamicPillarVFE'), ('VFE', 'DynPillarVFE'),
    ('BACKBONE_3D', 'UNetV2'), ('DENSE_HEAD', 'AnchorHeadMulti'),
    ('BACKBONE_2D', 'BaseBEVResBackbone'), ('ROI_HEAD', 'PartA2FCHead'),
    ('BACKBONE_3D', 'PointNet2MSG'), ('ROI_HEAD', 'PointRCNNHead'),
    ('VFE', 'ImageVFE')])
def test_converter_refuses_other_families(section, name):
    """The port's converter of reference checkpoints covers what
    glenet_tpu's covers of the families the port runs (VoxelRCNN,
    SECONDNet, SECOND-IoU's and PV-RCNN's stage 1, PointPillars,
    CenterPoint); any other module, and AnchorHeadMulti, the dynamic
    pillar VFE (both spellings) and CaDDN's ImageVFE, which glenet_tpu
    does not convert either, raises naming itself, before it reads a
    key."""
    import torch_parity as tp

    from glenet_tpu_torch.utils import weight_converter as wc
    cfg = tp.to_port_cfg(tp.tiny_twostage_cfg())
    cfg.MODEL[section].NAME = name
    with pytest.raises(NotImplementedError, match=name):
        wc.convert_full_model(cfg, {}, {'params': {}})


@pytest.mark.parametrize('name', ['VoxelResBackBone8x', 'CenterHead'])
def test_converter_accepts_centerpoint_pieces(name):
    """CenterPoint's backbone and head, which the converter refused before
    the port had them, convert: the toy CenterPoint (VoxelResBackBone8x)
    and the toy Voxel R-CNN (voxel-query pooling) with a CenterHead RPN each
    take a synthetic reference state dict whole into their own
    template."""
    import torch_parity as tp
    from test_torch_centerpoint import toy_cfg

    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils import synthetic
    from glenet_tpu_torch.utils import weight_converter as wc
    from glenet_tpu_torch.utils.jax_weights import (load_jax_variables,
                                                    port_to_jax_variables)
    if name == 'CenterHead':
        cfg = tp.voxel_query_cfg(tp.tiny_twostage_cfg())
        cfg.MODEL.DENSE_HEAD = toy_cfg().MODEL.DENSE_HEAD
    else:
        cfg = toy_cfg()
    cfg = tp.to_port_cfg(cfg)
    det = build_detector(cfg, device='cpu')
    sd = {k: v.numpy() for k, v in
          synthetic.pcdet_state_dict(cfg, seed=3).items()}
    merged, report = wc.convert_full_model(
        cfg, sd, port_to_jax_variables(det.net))
    assert report['unconsumed'] == []
    assert ('roi_head' in report['converted']) == (name == 'CenterHead')
    load_jax_variables(det.net, merged)
    assert type(det.net.dense_head).__name__ == 'CenterHead'


def test_waymo_pvrcnn_needs_a_card():
    """Waymo's PV-RCNN builds on the GPU by default and on the CPU when
    asked; without a card the default raises."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector

    cfg = cfg_from_yaml_file(str(ROOT / 'configs/waymo_models/pv_rcnn.yaml'))
    assert build_detector(cfg, device='cpu').device.type == 'cpu'
    if torch.cuda.is_available():
        assert build_detector(cfg).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_detector(cfg)


@pytest.mark.parametrize('section,key,value,match', [
    ('POINT_HEAD', 'NAME', 'PointHeadBox', 'POINT_HEAD PointHeadBox')])
def test_pvrcnn_plusplus_options_raise(section, key, value, match):
    """A PV-RCNN point head other than PointHeadSimple raises naming itself
    when the detector is built (PV-RCNN++'s own options build since it was
    ported: tests/test_torch_pvrcnn_plusplus.py)."""
    import torch_parity as tp

    from glenet_tpu_torch.models.detectors import build_detector

    cfg = tp.to_port_cfg(tp.tiny_pvrcnn_cfg())
    node = cfg.MODEL
    for part in section.split('.'):
        node = node[part]
    node[key] = value
    with pytest.raises(NotImplementedError, match=match):
        build_detector(cfg, device='cpu')


def _waymo_sdk_calls(tmp_path):
    """name -> a call of each SDK seam of datasets/waymo_raw.py."""
    from glenet_tpu_torch.datasets import waymo_raw
    return {
        '_iter_frames': lambda: next(waymo_raw._iter_frames(
            tmp_path / 'segment-0.tfrecord')),
        'extract_points': lambda: waymo_raw.extract_points(object()),
        'create_waymo_infos': lambda: waymo_raw.create_waymo_infos(
            tmp_path / 'raw', tmp_path / 'out'),
    }


@pytest.mark.parametrize('name,package', [
    ('_iter_frames', 'tensorflow'),
    ('extract_points', 'waymo_open_dataset'),
    ('create_waymo_infos', 'waymo-open-dataset')])
def test_waymo_sdk_seams_raise(name, package, tmp_path, monkeypatch):
    """The TFRecord decode and the range-image conversion need tensorflow
    and the waymo-open-dataset SDK, which neither this machine nor the
    card's has: each seam raises naming its package, before it writes
    anything."""
    for mod in ('tensorflow', 'waymo_open_dataset'):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError, match=package):
        _waymo_sdk_calls(tmp_path)[name]()
    assert not (tmp_path / 'out').exists()


def test_waymo_evaluation_needs_a_card(tmp_path):
    """The Waymo evaluation computes its IoUs on the GPU unless given the
    CPU; without a card it raises."""
    from glenet_tpu_torch.eval import waymo_eval
    gt = {'name': np.array(['Vehicle']),
          'boxes_lidar': np.array([[0, 0, 0, 4, 2, 1.6, 0.0]]),
          'num_points_in_gt': np.array([20])}
    det = dict(gt, score=np.array([0.9]))
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: nothing to refuse')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        waymo_eval.waymo_evaluation([det], [gt], ['Vehicle'])
    _, ret = waymo_eval.waymo_evaluation([det], [gt], ['Vehicle'],
                                         device='cpu')
    assert ret['OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP'] == pytest.approx(100)


def _weights_entry_points(tmp_path):
    """name -> a call of each entry point of the weights slice with its
    default device."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.tools import convert_weights
    from glenet_tpu_torch.train import jax_checkpoint
    cfg_file = str(ROOT / 'configs/kitti_models/GLENet_VR_vq.yaml')
    pth = tmp_path / 'missing.pth'
    return {
        'convert_weights': lambda: convert_weights.main(
            ['--cfg_file', cfg_file, '--torch_ckpt', str(pth),
             '--output_dir', str(tmp_path / 'out')]),
        'build_detector_from_checkpoint':
            lambda: jax_checkpoint.build_detector_from_checkpoint(
                cfg_from_yaml_file(cfg_file), tmp_path / 'x.msgpack'),
    }


@pytest.mark.parametrize('name', ['convert_weights',
                                  'build_detector_from_checkpoint'])
def test_weights_entry_points_need_a_card(name, tmp_path):
    """The converter CLI and the glenet_tpu checkpoint loader build the
    detector on the GPU unless given the CPU; without a card they raise
    before they read or write anything."""
    call = _weights_entry_points(tmp_path)[name]
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: nothing to refuse')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        call()
    assert not (tmp_path / 'out').exists()


@pytest.mark.parametrize('module', ['utils.weight_converter',
                                    'train.jax_checkpoint',
                                    'tools.convert_weights',
                                    'datasets.waymo_dataset',
                                    'datasets.waymo_raw',
                                    'datasets.waymo_utils',
                                    'eval.waymo_eval'])
def test_weights_modules_in_import_probe(module):
    """The modules of the weights slice and of the Waymo slice are among
    those the import probe of test_port_imports_no_jax walks, and import no
    JAX package (nor tensorflow or the Waymo SDK) at module level."""
    import ast
    import pkgutil

    import glenet_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(glenet_tpu_torch.__path__,
                                                   'glenet_tpu_torch.')}
    assert f'glenet_tpu_torch.{module}' in names
    src = (ROOT / 'glenet_tpu_torch' / (module.replace('.', '/') + '.py'))
    imported = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            imported |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module.split('.')[0])
    assert not imported & {'jax', 'flax', 'glenet_tpu', 'msgpack'}
    top = set()
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, ast.Import):
            top |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add(node.module.split('.')[0])
    assert not top & {'tensorflow', 'waymo_open_dataset'}


def test_convergence_waymo_default_raises_naming_centerpoint(tmp_path):
    """The Waymo harness's default config is CenterPoint's
    (configs/waymo_models/centerpoint.yaml), which the port builds now: on
    the CPU it is CenterPoint at full width, VoxelResBackBone8x and the
    CenterHead; without a card the harness's default device raises before
    it writes anything (the test's name is from before the port had the
    family, when the default raised naming it)."""
    from glenet_tpu_torch.tools import convergence_ap, convergence_waymo
    args = convergence_ap.parse_args(
        [], default_yaml=convergence_waymo.DEFAULT_YAML)
    cfg = convergence_ap.load_cfg(args.model_yaml)
    assert cfg.MODEL.NAME == 'CenterPoint' and args.device == 'cuda'
    det = convergence_ap.fresh_detector(cfg, 'cpu')
    assert det.is_center_head and tuple(det.grid_size) == (1504, 1504, 40)
    assert det.net.backbone_3d.residual
    out = tmp_path / 'results.json'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            convergence_waymo.main(['--out', str(out)])
    assert not out.exists()
