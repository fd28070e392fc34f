"""End-to-end quality check on the checkerboard: flow pretraining ->
2-NFE ArcFlow distillation from that teacher -> the share of the student's
samples inside the board's support, against ``--bar`` (the JAX package's
``tools/validate_toy_e2e.py``, through the port's ``train_model`` on
``--device``, the card unless ``cpu``). Exits non-zero below the bar.

    python -m arcflow_tpu_torch.tools.validate_toy_e2e [--work-dir DIR] \\
        [--flow-iters N] [--distill-iters N] [--num-samples 4096] \\
        [--bar 0.7] [--device cuda]
"""

import argparse
import os
import sys

FLOW_CONFIG = 'configs/toy/checkerboard_flow.py'
DISTILL_CONFIG = 'configs/toy/checkerboard_arcflow_2nfe.py'


def validate(work_dir: str, flow_iters=None, distill_iters=None,
             num_samples: int = 4096, device='cuda', repo: str = '.'):
    """Train both stages under ``work_dir``; returns the 2-NFE in-support
    share of ``num_samples`` samples of the distilled student (EMA) and
    the samples, (num_samples, 2) fp32 on the host."""
    import numpy as np
    import torch

    from ..apis import train_model
    from ..config import Config
    from ..data import CheckerboardData

    cfg = Config.fromfile(os.path.join(repo, FLOW_CONFIG))
    if flow_iters:
        cfg.merge_from_dict({'total_iters': flow_iters})
    cfg.work_dir = os.path.join(work_dir, 'flow')
    train_model(cfg, seed=0, device=device)
    print('flow pretraining done', flush=True)

    cfg2 = Config.fromfile(os.path.join(repo, DISTILL_CONFIG))
    overrides = {'model.teacher_ckpt': os.path.join(
        cfg.work_dir, 'checkpoints', 'checkerboard_flow')}
    if distill_iters:
        overrides['total_iters'] = distill_iters
    cfg2.merge_from_dict(overrides)
    cfg2.work_dir = os.path.join(work_dir, 'distill')
    state, model = train_model(cfg2, seed=0, device=device)
    print('distillation done', flush=True)

    samples = model.val_step(
        dict(num_samples=num_samples),
        torch.Generator(device=device).manual_seed(1),
        ema=state.ema.get('diffusion') if state.ema else None)
    samples = samples.float().cpu().numpy()
    if not np.isfinite(samples).all():
        raise AssertionError('non-finite samples')
    data = CheckerboardData(n_rc=cfg2.data.train.get('n_rc', 4))
    return float(data.log_prob_support(samples).mean()), samples


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--work-dir', default='work_dirs/toy_validate')
    p.add_argument('--flow-iters', type=int, default=None,
                   help='flow pretraining iterations (default: the config)')
    p.add_argument('--distill-iters', type=int, default=None)
    p.add_argument('--num-samples', type=int, default=4096)
    p.add_argument('--bar', type=float, default=0.7,
                   help='required 2-NFE in-support share')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    share, _ = validate(args.work_dir, args.flow_iters, args.distill_iters,
                     args.num_samples, args.device)
    print(f'2-NFE in-support: {share:.2%} (bar {args.bar:.0%})')
    if share < args.bar:
        sys.exit(f'FAIL: {share:.2%} < {args.bar:.0%}')
    print('VALIDATION OK')
    return share


if __name__ == '__main__':
    main()
