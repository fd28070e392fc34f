"""Parameter accounting of a config's model: trainable, frozen, total, the
trainable share and the adapter's bf16 size (the JAX package's
``tools/count_parameters.py``), the model built through ``Config`` and
``MODELS``. By default it is built on the ``meta`` device, which holds no
storage, so a 12B config costs no memory; ``--device cpu`` builds it for
real.

    python -m arcflow_tpu_torch.tools.count_parameters CONFIG [--device meta]
"""

import argparse


def count_parameters(config: str, device: str = 'meta'):
    """(trainable, frozen) parameter counts of ``config``'s model."""
    from ..apis import build_model_from_cfg
    from ..config import Config
    from ..runner import count_params
    model = build_model_from_cfg(Config.fromfile(config), device=device)
    trainable, frozen = model.init_params()
    return count_params(trainable), count_params(frozen)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    p.add_argument('--device', default='meta')
    args = p.parse_args(argv)
    n_t, n_f = count_parameters(args.config, args.device)
    total = n_t + n_f
    print(f'trainable: {n_t:,}')
    print(f'frozen:    {n_f:,}')
    print(f'total:     {total:,}')
    print(f'trainable ratio: {100 * n_t / max(total, 1):.3f}%')
    print(f'adapter size (bf16): {n_t * 2 / 1e6:.1f} MB')


if __name__ == '__main__':
    main()
