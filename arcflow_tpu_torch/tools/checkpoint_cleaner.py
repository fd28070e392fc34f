"""Prune old checkpoints: keep the newest ``--keep-last`` steps and every
multiple of ``--keep-every`` (the JAX package's
``tools/checkpoint_cleaner.py``; a step is a directory named by its
number, as both packages write them).

    python -m arcflow_tpu_torch.tools.checkpoint_cleaner CHECKPOINT_DIR \\
        [--keep-last 2] [--keep-every N] [--dry-run]
"""

import argparse
import os
import shutil


def clean(checkpoint_dir: str, keep_last: int = 2, keep_every: int = 0,
          dry_run: bool = False) -> list:
    """Remove the steps not kept; returns their paths (with ``dry_run``,
    the paths that would go)."""
    steps = sorted(int(d) for d in os.listdir(checkpoint_dir)
                   if d.isdigit())
    keep = set(steps[-keep_last:]) if keep_last else set()
    if keep_every:
        keep |= {s for s in steps if s % keep_every == 0}
    removed = []
    for s in steps:
        if s in keep:
            continue
        path = os.path.join(checkpoint_dir, str(s))
        print(('DRY-RUN would remove ' if dry_run else 'removing ') + path)
        if not dry_run:
            shutil.rmtree(path)
        removed.append(path)
    return removed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('checkpoint_dir')
    p.add_argument('--keep-last', type=int, default=2)
    p.add_argument('--keep-every', type=int, default=0,
                   help='steps at multiples of this are kept forever')
    p.add_argument('--dry-run', action='store_true')
    args = p.parse_args(argv)
    clean(args.checkpoint_dir, args.keep_last, args.keep_every, args.dry_run)


if __name__ == '__main__':
    main()
