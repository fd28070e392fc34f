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

On a mesh (``parallel/mesh.py:make_mesh``, the model sharded with
``parallel.shard_model``) each rank runs its rows of the global batch: its
per-sample draws are its rows of the global batch's (``batch_rows``), FSDP2
averages the gradients over the ranks, and the logged scalars are means
over the batch ranks and the per-sample values are gathered in batch
order, so the log is the one-device log of the global batch; under
``sp`` the ranks of an sp group hold the same rows, which count once. The
norm and with it the skip are the same on every rank
(``optim.global_norm``, over the gradients FSDP2 has averaged). Under
gradient accumulation chunk i of every rank together is chunk i of the
global batch, as JAX chunks it (the loaders deal its rows so,
``data.samplers.rank_rows``), and the gradients are reduced once, after
the last chunk (``parallel.fsdp.gradient_sync``). On a mesh with ``pipe``
or ``expert`` axes (the model placed by ``parallel.model_parallel.
partition_model``, no FSDP2) the ranks along them hold the same rows; the
gradients are averaged over ``data`` once, after the last chunk, and the
norm counts every stage's and expert's tensors once. On a mesh with a
``tensor`` axis (``parallel/tensor.py:partition_tensor``, then FSDP2 over
each tensor coordinate's data x fsdp mesh) the ranks of a tensor group hold
the same rows, FSDP2 averages the gradients over data x fsdp only, and the
norm sums a split tensor's squares over the group and counts a replicated
one once.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..parallel.fsdp import gradient_sync
from ..parallel.mesh import batch_order, batch_ranks, batch_rows
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


def global_logs(log_vars: dict, mesh) -> dict:
    """``log_vars`` of this rank's rows -> those of the global batch: the
    scalars' means over the ranks (one all-reduce; the ranks of an sp group
    hold the same rows and values, so this is the mean over the batch
    ranks), the per-sample tensors gathered in batch order, each row once
    (``batch_order`` takes one rank of each sp group)."""
    out = dict(log_vars)
    dev = torch.device(mesh.device_type)
    scalars = [k for k, v in log_vars.items()
               if isinstance(v, torch.Tensor) and v.dim() == 0]
    if scalars:
        vals = torch.stack([log_vars[k].detach().float().to(dev)
                            for k in scalars])
        dist.all_reduce(vals)
        vals /= dist.get_world_size()
        out.update(zip(scalars, vals.unbind()))
    order = batch_order(mesh)
    for k, v in log_vars.items():
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            v = v.detach().to(dev).contiguous()
            parts = [torch.empty_like(v)
                     for _ in range(dist.get_world_size())]
            dist.all_gather(parts, v)
            out[k] = torch.cat([parts[r] for r in order])
    return out


def build_train_step(model, optimizers: Dict[str, torch.optim.Optimizer],
                     train_cfg: Optional[dict] = None,
                     ema_cfg: Optional[EmaConfig] = None,
                     grad_accum_steps: int = 1, mesh=None):
    """``model.loss`` + optimizers + EMA as one step function.

    ``model`` exposes ``loss(batch, generator, running_status) -> (loss,
    log_vars)``, differentiable in ``state.trainable``. With no ``ema_cfg``
    the step updates no EMA. With ``mesh`` (the model sharded over it)
    ``batch`` is this rank's rows of the global batch. Returns
    ``train_step(state, batch) -> (state, log_vars)``; ``state`` is updated
    in place and returned.
    """
    train_cfg = dict(train_cfg or {})
    clip_cfgs = {k: GradClipConfig.from_train_cfg(train_cfg, k)
                 for k in optimizers}
    rows = batch_ranks(mesh) if mesh is not None else (0, 1)
    mp = getattr(model, 'model_parallel', None)

    def train_step(state: TrainState, batch: dict):
        iteration = state.step
        running_status = dict(iteration=iteration)
        params = {k: list(state.trainable[k].values()) for k in optimizers}
        for ps in params.values():
            for p in ps:
                p.grad = None

        logs = []
        with batch_rows(*rows):
            for i in range(grad_accum_steps):
                chunk = batch if grad_accum_steps == 1 \
                    else _chunk_batch(batch, grad_accum_steps, i)
                if mesh is not None and (mp is None
                                         or getattr(mp, 'fsdp', False)):
                    gradient_sync(model, i == grad_accum_steps - 1)
                loss, log_vars = model.loss(chunk, state.generator,
                                            running_status=running_status)
                (loss / grad_accum_steps).backward()
                log_vars = dict(loss=loss.detach(), **log_vars)
                logs.append(log_vars if mesh is None
                            else global_logs(log_vars, mesh))
        log_vars = logs[0] if grad_accum_steps == 1 else _merge_logs(logs)
        if mp is not None:
            mp.reduce_gradients(p for ps in params.values() for p in ps)

        for k, tx in optimizers.items():
            grads = []
            for p in params[k]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            counted = None if mp is None else \
                ([mp.counted(n) for n in state.trainable[k]],
                 mp.model_group)
            _, gnorm, skip = clip_and_skip(grads, iteration, clip_cfgs[k],
                                           counted)
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
