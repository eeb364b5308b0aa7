"""CVAE uncertainty analysis CLI of the port, the counterpart of the
repository's tools/cvae_analysis.py: loads pickles of per-pass predictions
(each a dict of one pass, `cvae.pipeline.predict_samples`'s items, or a
list of them) and prints the variance-against-IoU statistics of
cvae/analysis.py as JSON.

    python -m glenet_tpu_torch.tools.cvae_analysis passes.pkl [more.pkl ...]
        [--device cpu]

The 3D IoUs are computed on the GPU unless --device cpu is given; without
a GPU it raises.  `main(argv)` returns the report.
"""
from __future__ import annotations

import argparse
import json
import pickle


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('paths', nargs='+')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    from ..cvae.analysis import analyze
    from ..utils.common import resolve_device
    device = resolve_device(args.device)
    per_pass = []
    for p in args.paths:
        with open(p, 'rb') as f:
            data = pickle.load(f)
        if isinstance(data, list):
            per_pass.extend(data)
        else:
            per_pass.append(data)
    report = analyze(per_pass, device=device)
    print(json.dumps(report, indent=1))
    return report


if __name__ == '__main__':
    main()
