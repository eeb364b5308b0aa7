"""Convert a reference (OpenPCDet / GLENet) checkpoint into a checkpoint
of the port, the counterpart of the repository's tools/convert_weights.py:

    python -m glenet_tpu_torch.tools.convert_weights \
        --cfg_file configs/kitti_models/GLENet_VR_vq.yaml \
        --torch_ckpt /path/to/checkpoint_epoch_80.pth \
        --output_dir output/GLENet_VR_vq/converted [--device cpu]

Reads the `.pth` ({'model_state': ..., 'epoch': ...} or a bare state
dict) with torch.load(weights_only=True), converts it with
utils/weight_converter.convert_full_model into the port's freshly
initialised detector (exported as a glenet_tpu variables tree), prints the
conversion report, and writes `checkpoint_epoch_<N>.pth` (train/
checkpoint.py's format, with a fresh optimizer state), which `tools.test
--ckpt` evaluates.  The VoxelRCNN roi head converts exactly only with
POOL_MODE voxel_query (GLENet_VR_vq.yaml); in corner mode it keeps its
initialisation and its reference keys are reported as unconsumed.  The
detector is built on the GPU unless --device cpu is given; without a GPU
it raises.

`main(argv)` returns (the written path, the report).
"""
from __future__ import annotations

import argparse

# reference buffers that are no parameters of the model
EXPECTED_LEFTOVERS = ('global_step',)


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--torch_ckpt', type=str, required=True)
    parser.add_argument('--output_dir', type=str, required=True)
    parser.add_argument('--epoch', type=int, default=None,
                        help='epoch tag for the output file '
                             '(default: from the checkpoint, else 0)')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--set', dest='set_cfgs', nargs=argparse.REMAINDER,
                        default=None)
    args = parser.parse_args(argv)
    from ..config import cfg_from_list, cfg_from_yaml_file
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def load_torch_state_dict(path):
    """A reference .pth -> ({key: numpy array}, epoch or None)."""
    import torch
    blob = torch.load(path, map_location='cpu', weights_only=True)
    epoch = None
    if isinstance(blob, dict) and 'model_state' in blob:
        epoch = blob.get('epoch')
        blob = blob['model_state']
    return {k: v.numpy() for k, v in blob.items()}, epoch


def main(argv=None):
    args, cfg = parse_config(argv)
    from ..utils.common import resolve_device
    device = resolve_device(args.device)

    from ..models.detectors import build_detector
    from ..train import checkpoint as ckpt_lib
    from ..train import optim as optim_lib
    from ..train import state as state_lib
    from ..utils import jax_weights
    from ..utils import weight_converter as wc

    sd, ckpt_epoch = load_torch_state_dict(args.torch_ckpt)
    epoch = args.epoch if args.epoch is not None else (ckpt_epoch or 0)
    print(f'loaded {len(sd)} reference tensors from {args.torch_ckpt}')

    detector = build_detector(cfg, device=device)
    template = jax_weights.port_to_jax_variables(detector.net)
    merged, report = wc.convert_full_model(cfg, sd, template)
    print('converted subtrees:', ', '.join(report['converted']))
    leftovers = [k for k in report['unconsumed']
                 if not k.endswith(EXPECTED_LEFTOVERS)]
    if leftovers:
        print(f'WARNING: {len(leftovers)} reference tensors had no '
              f'destination (modules without a reference counterpart keep '
              f'their initialization):')
        for k in leftovers[:40]:
            print('  -', k)
        if len(leftovers) > 40:
            print(f'  ... and {len(leftovers) - 40} more')
    else:
        print('all reference tensors consumed')
    # raises on a leaf of the wrong shape or one without a destination
    jax_weights.load_jax_variables(detector.net, merged)

    tx, _ = optim_lib.build_optimizer(cfg.OPTIMIZATION, total_steps=1)
    ts = state_lib.create_train_state(detector, tx)
    out = ckpt_lib.save_checkpoint(
        ckpt_lib.checkpoint_state(ts, epoch=epoch, it=0), args.output_dir,
        epoch=epoch)
    print(f'wrote {out}')
    return out, report


if __name__ == '__main__':
    main()
