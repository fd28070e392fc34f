"""ArcFlow adapter files: the trainable adapter (the three heads,
``norm_out``, LoRA) as safetensors in diffusers naming, with the sampling
policy as JSON under ``policy_config`` in the file's metadata.

Counterpart of ``arcflow_tpu/pipelines/loader.py``: a file either package
writes loads in the other. A remote URI (``huggingface://``, ``s3://``,
``http(s)://``) is read through ``utils/io_utils``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import torch

from .convert import diffusers_to_torch, torch_to_diffusers


def save_adapter_state(path: str, state: Mapping[str, torch.Tensor],
                       policy_config: Optional[dict] = None,
                       family: str = 'flux') -> None:
    """Write an adapter (the port's ``state_dict`` keys) in diffusers naming
    and packed layout, with ``policy_config`` in the metadata."""
    from safetensors.torch import save_file
    out = {k: v.detach().cpu().contiguous()
           for k, v in torch_to_diffusers(state, family=family).items()}
    meta = None if policy_config is None \
        else {'policy_config': json.dumps(policy_config)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_file(out, path, metadata=meta)


def load_adapter_state(path: str, family: str = 'flux'
                       ) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """An adapter file -> (the port's ``state_dict`` keys,
    ``policy_config`` or None). LoRA keys come plain or peft-style
    (``lora_A.default.weight``); a key no map takes raises, as in JAX.
    ``path`` may be a remote URI: the hub's cached file is read in place,
    another backend's bytes go through a temporary file, removed after."""
    from safetensors import safe_open

    from ..utils.io_utils import local_file
    with local_file(path, suffix='.safetensors') as local, \
            safe_open(local, framework='pt') as f:
        meta = f.metadata() or {}
        state = {k: f.get_tensor(k) for k in f.keys()}
    policy_config = json.loads(meta['policy_config']) \
        if 'policy_config' in meta else None
    out, unused = diffusers_to_torch(
        state, num_layers=_blocks(state, 'transformer_blocks'),
        num_single_layers=_blocks(state, 'single_transformer_blocks'),
        family=family)
    if unused:
        raise ValueError(f'adapter contains {len(unused)} unconvertible '
                         f'keys, e.g. {sorted(unused)[:5]}')
    return out, policy_config


def _blocks(state: Mapping, prefix: str) -> int:
    """One past the largest block index under ``prefix``."""
    return 1 + max((int(k.split('.')[1]) for k in state
                    if k.startswith(prefix + '.')), default=-1)
