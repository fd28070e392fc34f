"""Config-driven model initialization for evaluation and inference.

Counterpart of ``arcflow_tpu/apis/inference.py:init_model``: build the
model from a config on the card (unless the caller asks for the CPU),
restore a training checkpoint of the port's format
(``runner/checkpoint.py``) and return what ``model.val_step`` needs.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import Config
from ..runner import TrainState, load_raw_checkpoint
from .train import build_model_from_cfg


def init_model(config: Union[str, Config], checkpoint: Optional[str] = None,
               step: Optional[int] = None, ema_only: bool = True,
               seed: int = 0, device='cuda'):
    """(model, state) ready for ``model.val_step(batch, generator,
    ema=state.ema and state.ema['diffusion'])``.

    ``checkpoint`` is a checkpoint directory (``step`` the latest by
    default). With ``ema_only`` (and an EMA in the checkpoint) the EMA
    becomes the model's live weights and the state keeps no EMA, as the
    reference drops the non-EMA copy; else the live weights are the
    trained ones and the EMA slot holds the checkpoint's EMA. JAX leaves
    its freshly initialised EMA in that slot
    (``arcflow_tpu/apis/inference.py:48-50``); the port loads the
    checkpoint's."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    torch.manual_seed(seed)
    model = build_model_from_cfg(config, device=device)
    trainable, frozen = model.init_params()
    state = TrainState.create(torch.Generator(device).manual_seed(seed),
                              trainable, frozen, ema_keys=model.ema_keys)
    if checkpoint is None:
        return model, state
    raw = load_raw_checkpoint(checkpoint, step=step)
    use_ema = ema_only and bool(raw.get('ema'))
    with torch.no_grad():
        for k, sub in state.trainable.items():
            src = (raw['ema'] if use_ema else raw['trainable'])[k]
            for n, t in sub.items():
                t.copy_(src[n])
        if ema_only:
            state.ema = None
        elif state.ema is not None and raw.get('ema'):
            for k, sub in state.ema.items():
                for n, t in sub.items():
                    t.copy_(raw['ema'][k][n])
    state.step = int(raw.get('step', 0))
    return model, state
