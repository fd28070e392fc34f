"""Strip a training checkpoint to its inference weights: the EMA (or, with
``--no-ema`` or no EMA in the checkpoint, the live) trainable tensors, no
optimizer state, cast to ``--dtype``, in one safetensors file (the JAX
package's ``tools/save_inference_weights.py``). Keys are
``<submodule>.<state_dict key>`` (JAX's are its flattened flax paths).

    python -m arcflow_tpu_torch.tools.save_inference_weights CHECKPOINT_DIR \\
        OUT.safetensors [--step N] [--no-ema] [--dtype bfloat16]
"""

import argparse
import os

DTYPES = ('float32', 'bfloat16', 'float16')


def save_inference_weights(checkpoint_dir: str, out: str, step=None,
                           no_ema: bool = False, dtype: str = 'bfloat16'
                           ) -> int:
    """Write the weights; returns their number of parameters."""
    import torch
    from safetensors.torch import save_file

    from ..runner.checkpoint import load_raw_checkpoint
    raw = load_raw_checkpoint(checkpoint_dir, step=step)
    src = raw['trainable'] if no_ema or not raw.get('ema') else raw['ema']
    dt = getattr(torch, dtype)
    state = {f'{k}.{n}': t.to(dt).contiguous()
             for k, sub in src.items() for n, t in sub.items()}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_file(state, out)
    return sum(t.numel() for t in state.values())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('checkpoint_dir')
    p.add_argument('out', help='output .safetensors path')
    p.add_argument('--step', type=int, default=None)
    p.add_argument('--no-ema', action='store_true')
    p.add_argument('--dtype', choices=DTYPES, default='bfloat16')
    args = p.parse_args(argv)
    n = save_inference_weights(args.checkpoint_dir, args.out, args.step,
                               args.no_ema, args.dtype)
    print(f'saved {n:,} params to {args.out}')


if __name__ == '__main__':
    main()
