"""The train step: gradient accumulation -> per-submodule clip/skip ->
optimizer update -> EMA.

Counterpart of ``arcflow_tpu/runner/train_step.py:build_train_step``. The
JAX step is one compiled program returning a new state; here it runs
eagerly and updates the ``TrainState`` in place. Gradient accumulation runs
one backward per batch chunk and averages; a skipped step (non-finite or
too large a norm) calls no optimizer, so the parameters and the optimizer
state stay exactly as they were, and logs a NaN grad norm. The EMA is
updated every step, skipped or not, as in the JAX step. Host offload of the
cold state is not ported (the H100 holds it).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .ema import EmaConfig, ema_update
from .optim import GradClipConfig, clip_and_skip
from .train_state import TrainState


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _chunk_batch(batch: dict, steps: int, i: int) -> dict:
    """Chunk ``i`` of ``steps`` of every leaf (B, ...) along B."""
    def leaf(x):
        b = x.shape[0]
        if b % steps:
            raise ValueError(f'batch size {b} not divisible by grad_accum '
                             f'steps {steps}')
        return x[i * (b // steps):(i + 1) * (b // steps)]
    return _tree_map(leaf, batch)


def _merge_logs(logs):
    """Scalars per chunk -> their mean; per-sample tensors -> concatenated."""
    out = {}
    for k in logs[0]:
        vals = [torch.as_tensor(lv[k]) for lv in logs]
        out[k] = torch.stack(vals).float().mean() if vals[0].dim() == 0 \
            else torch.cat(vals, dim=0)
    return out


def build_train_step(model, optimizers: Dict[str, torch.optim.Optimizer],
                     train_cfg: Optional[dict] = None,
                     ema_cfg: Optional[EmaConfig] = None,
                     grad_accum_steps: int = 1):
    """``model.loss`` + optimizers + EMA as one step function.

    ``model`` exposes ``loss(batch, generator, running_status) -> (loss,
    log_vars)``, differentiable in ``state.trainable``. With no ``ema_cfg``
    the step updates no EMA. Returns
    ``train_step(state, batch) -> (state, log_vars)``; ``state`` is updated
    in place and returned.
    """
    train_cfg = dict(train_cfg or {})
    clip_cfgs = {k: GradClipConfig.from_train_cfg(train_cfg, k)
                 for k in optimizers}
    def train_step(state: TrainState, batch: dict):
        iteration = state.step
        running_status = dict(iteration=iteration)
        params = {k: list(state.trainable[k].values()) for k in optimizers}
        for ps in params.values():
            for p in ps:
                p.grad = None

        logs = []
        for i in range(grad_accum_steps):
            chunk = batch if grad_accum_steps == 1 \
                else _chunk_batch(batch, grad_accum_steps, i)
            loss, log_vars = model.loss(chunk, state.generator,
                                        running_status=running_status)
            (loss / grad_accum_steps).backward()
            logs.append(dict(loss=loss.detach(), **log_vars))
        log_vars = logs[0] if grad_accum_steps == 1 else _merge_logs(logs)

        for k, tx in optimizers.items():
            grads = []
            for p in params[k]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            _, gnorm, skip = clip_and_skip(grads, iteration, clip_cfgs[k])
            if not skip:
                tx.step()
            tx.zero_grad(set_to_none=True)
            log_vars[f'{k}_grad_norm'] = math.nan if skip else float(gnorm)
            log_vars[f'{k}_skipped'] = float(skip)

        if state.ema is not None and ema_cfg is not None:
            for k in state.ema:
                ema_update(ema_cfg, state.ema[k], state.trainable[k],
                           iteration)
        state.step = iteration + 1
        return state, log_vars

    return train_step
