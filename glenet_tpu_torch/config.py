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
