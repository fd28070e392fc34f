"""Export a trained ArcFlow adapter to a diffusers-style folder.

Counterpart of the repository root's ``export_arcflow_to_diffusers.py``
(the JAX package's): reads the port's checkpoint (``state.pt``, through
``runner/checkpoint.py:load_raw_checkpoint``; a remote checkpoint URI is
fetched first), takes the EMA adapter (the live one with ``--no-ema``, or
when the checkpoint has no EMA), and writes

* ``diffusion_pytorch_model.safetensors``: the adapter (heads,
  ``norm_out``, LoRA) in diffusers naming and packed layout, with the
  sampling policy as JSON under ``policy_config`` in its metadata
  (``pipelines/loader.py:save_adapter_state``), which
  ``ArcFluxPipeline.load_arcflow_adapter`` serves;
* ``config.json``: ``_class_name`` (the Arc class) and the denoiser's
  config, without the training-time load paths ``pretrained`` and
  ``pretrained_adapter``.

It computes nothing and reads on the host. JAX's ``--platform`` flag pins
the JAX platform and has no counterpart here.

    python -m arcflow_tpu_torch.export_arcflow_to_diffusers CONFIG \\
        CHECKPOINT_DIR OUT_DIR [--step N] [--no-ema]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional


def export(config: str, checkpoint_dir: str, out_dir: str,
           step: Optional[int] = None, no_ema: bool = False) -> dict:
    """Write the adapter and ``config.json`` of ``checkpoint_dir`` (at
    ``step``, the latest by default) to ``out_dir``; returns the
    ``policy_config`` written."""
    from .config import Config
    from .pipelines.loader import save_adapter_state
    from .runner.checkpoint import load_raw_checkpoint

    cfg = Config.fromfile(config)
    raw = load_raw_checkpoint(checkpoint_dir, step=step)
    src = raw['trainable'] if no_ema or not raw.get('ema') else raw['ema']
    adapter = src['diffusion']

    den_cfg = dict(cfg.model.diffusion.denoising)
    arc_class = den_cfg.pop('type')
    den_cfg.pop('pretrained', None)
    den_cfg.pop('pretrained_adapter', None)
    test_cfg = dict(cfg.get('test_cfg', {}) or {})
    policy_config = dict(
        policy_type=cfg.model.diffusion.get('policy_type', 'ArcFlow'),
        nfe=test_cfg.get('nfe', 2),
        timestep_ratio=test_cfg.get('timestep_ratio', 1.0),
        total_substeps=test_cfg.get('total_substeps', 128),
        num_gaussians=den_cfg.get('num_gaussians', 16))

    os.makedirs(out_dir, exist_ok=True)
    family = 'qwen' if 'Qwen' in arc_class else 'flux'
    save_adapter_state(
        os.path.join(out_dir, 'diffusion_pytorch_model.safetensors'),
        adapter, policy_config=policy_config, family=family)
    with open(os.path.join(out_dir, 'config.json'), 'w') as f:
        json.dump(dict(_class_name=arc_class, **den_cfg), f, indent=2)
    return policy_config


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    p.add_argument('checkpoint_dir', help="the run's checkpoint directory")
    p.add_argument('out_dir')
    p.add_argument('--step', type=int, default=None)
    p.add_argument('--no-ema', action='store_true')
    args = p.parse_args(argv)
    export(args.config, args.checkpoint_dir, args.out_dir, step=args.step,
           no_ema=args.no_ema)
    print(f'exported adapter to {args.out_dir}')


if __name__ == '__main__':
    main()
