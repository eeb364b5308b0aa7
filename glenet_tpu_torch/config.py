"""Config system: YAML -> attribute-dict with `_BASE_CONFIG_` inheritance and
dotted-path overrides.

The port's own copy of glenet_tpu/config.py (same schema and semantics:
CLASS_NAMES / DATA_CONFIG / MODEL / OPTIMIZATION, `_BASE_CONFIG_`
resolution at any nesting level, typed `cfg_from_list`).
"""
from __future__ import annotations

import ast
import copy
from pathlib import Path

import yaml


class Cfg(dict):
    """Attribute-accessible nested dict (recursive)."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, Cfg):
            value = Cfg(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                Cfg(v) if isinstance(v, dict) and not isinstance(v, Cfg) else v
                for v in value
            )
        super().__setitem__(key, value)

    __setattr__ = __setitem__

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        del self[key]

    def __deepcopy__(self, memo):
        return Cfg({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _resolve_base_path(path: str) -> str:
    """_BASE_CONFIG_ paths resolve against cwd first, falling back to the
    repo root so configs work from any directory."""
    p = Path(path)
    if p.exists():
        return str(p)
    repo_rel = Path(__file__).resolve().parent.parent / path
    if repo_rel.exists():
        return str(repo_rel)
    return str(p)  # let open() raise a clear error


def merge_new_config(config: Cfg, new_config: dict) -> Cfg:
    """Recursively merge `new_config` into `config`, resolving _BASE_CONFIG_
    at any nesting level (the reference nests it under DATA_CONFIG)."""
    if '_BASE_CONFIG_' in new_config:
        with open(_resolve_base_path(new_config['_BASE_CONFIG_']), 'r') as f:
            base = yaml.safe_load(f)
        merge_new_config(config, base)
    for key, val in new_config.items():
        if key == '_BASE_CONFIG_':
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config[key], dict):
                config[key] = Cfg()
            merge_new_config(config[key], val)
        else:
            config[key] = copy.deepcopy(val)
    return config


def cfg_from_yaml_file(cfg_file, config: Cfg | None = None) -> Cfg:
    config = Cfg() if config is None else config
    with open(cfg_file, 'r') as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config=config, new_config=new_config)
    config.TAG = Path(cfg_file).stem
    config.EXP_GROUP_PATH = '/'.join(str(cfg_file).split('/')[1:-1])
    return config


def _parse_value(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def cfg_from_list(cfg_list, config: Cfg) -> None:
    """Set config keys via dotted-path list, e.g. MODEL.NAME PointPillar,
    including the `KEY:INDEX` syntax for one element of a list, as the last
    key or inside the path (DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST:0.
    DB_INFO_PATH)."""
    if len(cfg_list) % 2:
        raise ValueError('override list must be key/value pairs')
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        keys = full_key.split('.')
        d = config
        for subkey in keys[:-1]:
            key, *rest = subkey.split(':')
            if subkey not in d and rest and key in d:
                d = d[key][int(rest[0])]
                continue
            if subkey not in d:
                raise KeyError(f'unknown config key: {full_key}')
            d = d[subkey]
        subkey = keys[-1]
        value = _parse_value(v)
        if subkey not in d:
            key, *rest = subkey.split(':')
            if rest and key in d:
                d[key][int(rest[0])] = _parse_value(v)
                continue
            raise KeyError(f'unknown config key: {full_key}')
        if (isinstance(d[subkey], (list, tuple))
                and not isinstance(value, (list, tuple))):
            value = type(d[subkey])(_parse_value(x) for x in str(v).split(','))
        d[subkey] = value


# ---------------------------------------------------------------------------
# run-time configs: no yaml under configs/ pairs a model with the nuScenes,
# Lyft or Pandaset dataset, so these are a published model yaml's MODEL and
# OPTIMIZATION over a dataset yaml with the overrides each needs.  Write one
# as a yaml that every CLI and profiler takes:
#   python -m glenet_tpu_torch.config NAME OUT.yaml [--data_path DIR]
# ---------------------------------------------------------------------------

_REPO = Path(__file__).resolve().parent.parent
DATASET_YAMLS = {
    'nuscenes': 'configs/dataset_configs/nuscenes_dataset.yaml',
    'lyft': 'configs/dataset_configs/lyft_dataset.yaml',
    'pandaset': 'configs/dataset_configs/pandaset_dataset.yaml'}
RUN_CFGS = {
    'nuscenes_centerpoint': ('configs/waymo_models/centerpoint.yaml',
                             DATASET_YAMLS['nuscenes']),
    'lyft_second_multihead': ('configs/kitti_models/second_multihead.yaml',
                              DATASET_YAMLS['lyft']),
    'pandaset_second': ('configs/kitti_models/second.yaml',
                        DATASET_YAMLS['pandaset'])}
# the 10 classes of the nuScenes detection task
NUSCENES_CLASSES = ['car', 'truck', 'construction_vehicle', 'bus', 'trailer',
                    'barrier', 'motorcycle', 'bicycle', 'pedestrian',
                    'traffic_cone']


def repo_yaml(rel):
    """The yaml at `rel` under the repository's root as a plain dict."""
    with open(_REPO / rel) as f:
        return yaml.safe_load(f)


def run_cfg_dict(name, data_path=None):
    """The run-time config `name` of RUN_CFGS as a plain nested dict, its
    DATA_CONFIG.DATA_PATH set to `data_path` when given:

      - 'nuscenes_centerpoint': configs/waymo_models/centerpoint.yaml
        over nuscenes_dataset.yaml, the 10 nuScenes classes as CLASS_NAMES
        and as the CenterHead's one head group (OpenPCDet's
        cbgs_voxel01_res3d_centerpoint.yaml has six);
      - 'lyft_second_multihead': configs/kitti_models/second_multihead.yaml
        over lyft_dataset.yaml with the sin/cos box coder (BOX_CODER_CONFIG
        encode_angle_by_sincos, as OpenPCDet's cbgs_*_multihead.yaml), car,
        pedestrian and bicycle as the classes (the anchors' and heads'
        class names renamed; sizes, heights and thresholds as published),
        and 8 code weights, one per code of the sin/cos coder;
      - 'pandaset_second': configs/kitti_models/second.yaml over
        pandaset_dataset.yaml, second.yaml's Car, Pedestrian and Cyclist,
        gt sampling's NUM_POINT_FEATURES 5 (the yaml's 4 does not build in
        glenet_tpu, whose adapter pads the points to 5 columns).
    """
    model_yaml, data_yaml = RUN_CFGS[name]
    raw = repo_yaml(model_yaml)
    raw['DATA_CONFIG'] = repo_yaml(data_yaml)
    m = raw['MODEL']
    if name == 'nuscenes_centerpoint':
        raw['CLASS_NAMES'] = list(NUSCENES_CLASSES)
        m['DENSE_HEAD']['CLASS_NAMES_EACH_HEAD'] = [list(NUSCENES_CLASSES)]
    elif name == 'lyft_second_multihead':
        rename = {'Car': 'car', 'Pedestrian': 'pedestrian',
                  'Cyclist': 'bicycle'}
        raw['CLASS_NAMES'] = [rename[c] for c in raw['CLASS_NAMES']]
        head = m['DENSE_HEAD']
        for a in head['ANCHOR_GENERATOR_CONFIG']:
            a['class_name'] = rename[a['class_name']]
        for h in head['RPN_HEAD_CFGS']:
            h['HEAD_CLS_NAME'] = [rename[c] for c in h['HEAD_CLS_NAME']]
        head['TARGET_ASSIGNER_CONFIG']['BOX_CODER_CONFIG'] = {
            'encode_angle_by_sincos': True}
        head['LOSS_CONFIG']['LOSS_WEIGHTS']['code_weights'] = [1.0] * 8
    elif name == 'pandaset_second':
        raw['DATA_CONFIG']['DATA_AUGMENTOR']['AUG_CONFIG_LIST'][0][
            'NUM_POINT_FEATURES'] = 5
    if data_path is not None:
        raw['DATA_CONFIG']['DATA_PATH'] = str(data_path)
    raw['TAG'] = name
    return raw


def write_run_cfg(name, path, data_path=None):
    """Write run_cfg_dict(name, data_path) to the yaml file `path` (its
    stem becomes the config's TAG when read back); returns `path`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(run_cfg_dict(name, data_path)))
    return path


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser(
        description='write a run-time config (RUN_CFGS) as a yaml file')
    parser.add_argument('name', choices=sorted(RUN_CFGS))
    parser.add_argument('output', help='the yaml file to write')
    parser.add_argument('--data_path', default=None,
                        help="the dataset's root (default: the dataset "
                             "yaml's DATA_PATH)")
    args = parser.parse_args()
    print(write_run_cfg(args.name, args.output, args.data_path))
