"""Guards of the port: glenet_tpu_torch and chip_smoke.py import neither
JAX nor glenet_tpu nor scikit-learn (the machine with the card has none of
them), the port never quietly defaults to the CPU, and what
is not ported yet (augmentations, datasets, camera items, CLI flags)
raises NotImplementedError naming itself."""
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
                                    'glenet_tpu', 'sklearn'))
print('BAD', bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, '-c', _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert 'BAD []' in out.stdout, out.stdout


def test_build_detector_needs_a_device():
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector

    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    if torch.cuda.is_available():
        assert build_detector(cfg).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_detector(cfg)


def test_other_families_raise():
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import build_detector

    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/second.yaml'))
    with pytest.raises(NotImplementedError):
        build_detector(cfg, device='cpu')


@pytest.mark.parametrize('section,key,value', [
    ('DENSE_HEAD.TARGET_ASSIGNER_CONFIG', 'MATCH_HEIGHT', True),
    ('ROI_HEAD.TARGET_CONFIG', 'CLS_SCORE_TYPE', 'cls')])
def test_unported_options_raise(section, key, value):
    """Options of the ported modules that no GLENet-VR config sets are
    refused, not computed some other way."""
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


@pytest.mark.parametrize('cli', ['train', 'test'])
def test_clis_need_a_card(cli, tmp_path):
    """The train and test CLIs run on the GPU unless --device cpu is
    given; importing them runs nothing."""
    import importlib
    mod = importlib.import_module(f'glenet_tpu_torch.tools.{cli}')
    argv = ['--cfg_file', str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'),
            '--output_dir', str(tmp_path)]
    if torch.cuda.is_available():
        assert mod.parse_config(argv)[0].device == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            mod.main(argv)
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


@pytest.mark.parametrize('flag', ['--coordinator_address', '--num_processes',
                                  '--process_id', '--workers'])
def test_train_cli_refuses_multi_host_flags(flag, tmp_path):
    from glenet_tpu_torch.tools import train
    value = 'localhost:1234' if flag == '--coordinator_address' else '2'
    with pytest.raises(NotImplementedError, match=flag):
        train.main(['--cfg_file',
                    str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'),
                    '--output_dir', str(tmp_path), '--device', 'cpu',
                    flag, value])


@pytest.mark.parametrize('name', ['random_image_flip', 'noise_per_object',
                                  'random_world_translation',
                                  'random_local_rotation',
                                  'random_local_pyramid_aug'])
def test_unported_augmentations_raise(name, tmp_path):
    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.datasets.augmentor import DataAugmentor
    cfg = Cfg({'DISABLE_AUG_LIST': ['placeholder'],
               'AUG_CONFIG_LIST': [{'NAME': name},
                                   {'NAME': 'random_world_flip',
                                    'ALONG_AXIS_LIST': ['x']}]})
    with pytest.raises(NotImplementedError, match=name):
        DataAugmentor(tmp_path, cfg, ['Car'])
    # a disabled name is skipped, as in the JAX package
    cfg.DISABLE_AUG_LIST = [name]
    assert len(DataAugmentor(tmp_path, cfg, ['Car']).queue) == 1


@pytest.mark.parametrize('name', ['WaymoDataset', 'NuScenesDataset',
                                  'LyftDataset', 'PandasetDataset'])
def test_unported_datasets_raise(name):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets import build_dataset
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    cfg.DATA_CONFIG.DATASET = name
    with pytest.raises(NotImplementedError, match=name):
        build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False)


@pytest.mark.parametrize('item', ['images', 'depth_maps', 'calib_matricies',
                                  'gt_boxes2d'])
def test_camera_items_raise(item, tmp_path):
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import KittiDataset
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    cfg.DATA_CONFIG.GET_ITEM_LIST = ['points', item]
    with pytest.raises(NotImplementedError, match=item):
        KittiDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False,
                     root_path=tmp_path)
