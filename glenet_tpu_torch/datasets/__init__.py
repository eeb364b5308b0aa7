"""Dataset registry: DATA_CONFIG.DATASET selects the adapter, KittiDataset
or WaymoDataset; every other dataset raises NotImplementedError naming
itself."""
from __future__ import annotations


def build_dataset(data_cfg, class_names, training=True, root_path=None,
                  logger=None, seed=None):
    name = data_cfg.get('DATASET', 'KittiDataset')
    if name == 'KittiDataset':
        from .kitti_dataset import KittiDataset as cls
    elif name == 'WaymoDataset':
        from .waymo_dataset import WaymoDataset as cls
    else:
        raise NotImplementedError(f'DATASET {name} is not ported yet')
    return cls(data_cfg, class_names, training=training,
               root_path=root_path, logger=logger, seed=seed)


__all__ = ['build_dataset']
