"""Training CLI of the port:

    python -m arcflow_tpu_torch.train <config> [--work-dir DIR] [--seed N]
        [--no-resume] [--cfg-options k=v ...] [--device cuda|cpu]

The root ``train.py`` with ``--device`` in place of ``--platform``. It
trains on the card by default, and exits non-zero without one unless
``--device cpu`` is given. A run that gets SIGTERM or SIGINT finishes its
iteration, saves a checkpoint and exits 0; the same command resumes it.

On N cards, one process per card:

    python -m torch.distributed.run --nproc-per-node N \
        -m arcflow_tpu_torch.train <config>

With ``WORLD_SIZE`` above 1 (from the launcher or the config's
``dist_params``, read as JAX reads them) the process group starts before
anything is built: NCCL on the card, gloo with ``--device cpu``. The
config's ``parallel.mesh`` lays the ranks out.
"""

import argparse
import sys

import torch

import torch.distributed as dist

from arcflow_tpu_torch import Config
from arcflow_tpu_torch.apis import train_model
from arcflow_tpu_torch.parallel.launch import apply_dist_params
from arcflow_tpu_torch.parallel.mesh import setup_distributed


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
    distributed = apply_dist_params(cfg.get('dist_params')) > 1
    if distributed:
        setup_distributed(args.device)
    try:
        train_model(cfg, work_dir=args.work_dir, resume=not args.no_resume,
                    seed=args.seed, device=args.device)
    finally:
        if distributed:
            dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
