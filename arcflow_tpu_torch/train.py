"""Training CLI of the port:

    python -m arcflow_tpu_torch.train <config> [--work-dir DIR] [--seed N]
        [--no-resume] [--cfg-options k=v ...] [--device cuda|cpu]

The root ``train.py`` with ``--device`` in place of ``--platform``. It
trains on the card by default, and exits non-zero without one unless
``--device cpu`` is given. A run that gets SIGTERM or SIGINT finishes its
iteration, saves a checkpoint and exits 0; the same command resumes it.
"""

import argparse
import sys

import torch

from arcflow_tpu_torch import Config
from arcflow_tpu_torch.apis import train_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a model from a config '
                                            'file with the PyTorch port')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--no-resume', action='store_true',
                   help='do not auto-resume from the latest checkpoint')
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='dot-keyed config overrides, e.g. total_iters=100')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='train on the card (default) or, for tests, on the '
                        'CPU')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('arcflow_tpu_torch.train: no CUDA device is available; pass '
              '--device cpu to train on the CPU', file=sys.stderr)
        return 2
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        overrides = {}
        for opt in args.cfg_options:
            k, _, v = opt.partition('=')
            overrides[k] = v
        cfg.merge_from_dict(overrides)
    train_model(cfg, work_dir=args.work_dir, resume=not args.no_resume,
                seed=args.seed, device=args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
