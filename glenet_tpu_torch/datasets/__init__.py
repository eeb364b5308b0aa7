"""Dataset registry: DATA_CONFIG.DATASET selects the adapter.  Only
KittiDataset is ported; every other dataset raises NotImplementedError."""
from __future__ import annotations


def build_dataset(data_cfg, class_names, training=True, root_path=None,
                  logger=None, seed=None):
    name = data_cfg.get('DATASET', 'KittiDataset')
    if name != 'KittiDataset':
        raise NotImplementedError(f'DATASET {name} is not ported yet')
    from .kitti_dataset import KittiDataset
    return KittiDataset(data_cfg, class_names, training=training,
                        root_path=root_path, logger=logger, seed=seed)


__all__ = ['build_dataset']
