"""Label-uncertainty generation CLI of the port, the counterpart of the
repository's tools/cvae_train.py:

    python -m glenet_tpu_torch.tools.cvae_train
        --cfg_file configs/cvae/exp_gen.yaml --data_path data/kitti
        [--folds 10] [--passes 30] [--epochs N]
        [--output_dir output/uncertainty_dump] [--inject] [--device cpu]

K-fold CVAE training on the crops of kitti_dbinfos_train.pkl, N stochastic
prediction passes per fold, the per-object variance map (un_v4.pkl in
--output_dir) and, with --inject, `uncertainty` written into
kitti_infos_train.pkl / kitti_dbinfos_train.pkl as
kitti_infos_train_wconf.pkl / kitti_dbinfos_train_wconf.pkl beside them.
Runs on the GPU unless --device cpu is given; without a GPU it raises.

`main(argv)` returns the uncertainty map.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--data_path', type=str, required=True)
    parser.add_argument('--folds', type=int, default=10)
    parser.add_argument('--passes', type=int, default=30)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--output_dir', type=str,
                        default='output/uncertainty_dump')
    parser.add_argument('--inject', action='store_true',
                        help='write *_wconf.pkl infos with uncertainty')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..utils.common import create_logger, resolve_device
    device = resolve_device(args.device)
    from ..config import cfg_from_yaml_file
    from ..cvae import pipeline

    cfg = cfg_from_yaml_file(args.cfg_file)
    logger = create_logger()
    data_path = Path(args.data_path)

    unc_map = pipeline.run_kfold_pipeline(
        cfg, data_path, n_folds=args.folds, n_passes=args.passes,
        logger=logger, num_epochs=args.epochs, output_dir=args.output_dir,
        device=device)
    logger.info(f'uncertainty map: {len(unc_map)} objects '
                f'-> {args.output_dir}/un_v4.pkl')

    if args.inject:
        with open(data_path / 'kitti_infos_train.pkl', 'rb') as f:
            infos = pickle.load(f)
        with open(data_path / 'kitti_dbinfos_train.pkl', 'rb') as f:
            db = pickle.load(f)
        infos, db = pipeline.change_gt_infos(unc_map, infos, db)
        with open(data_path / 'kitti_infos_train_wconf.pkl', 'wb') as f:
            pickle.dump(infos, f)
        with open(data_path / 'kitti_dbinfos_train_wconf.pkl', 'wb') as f:
            pickle.dump(db, f)
        logger.info('wrote kitti_infos_train_wconf.pkl / '
                    'kitti_dbinfos_train_wconf.pkl: point INFO_PATH / '
                    'DB_INFO_PATH at these to train with label uncertainty')
    return unc_map


if __name__ == '__main__':
    main()
