"""Optimizer construction with per-key lr multipliers, and gradient clipping
with a skip on non-finite norms.

Counterpart of ``arcflow_tpu/runner/optim.py``: one AdamW per trainable
submodule; ``paramwise_cfg.custom_keys`` maps a name substring to
``dict(lr_mult=m)`` (the configs use 0.1 on ``proj_out_loggamma``), here a
parameter group with lr * m; ``clip_and_skip`` clips to ``max_norm`` from
``begin_iter`` on and flags a step to skip when the norm is not finite or
passes ``max_norm * skip_ratio``. The JAX step selects the old state
branchlessly on a skip; here the step does not call the optimizer. Only
AdamW, the configs' optimizer, is ported. Sharded gradients (``DTensor``s,
``parallel/fsdp.py``) give the norm of the whole gradient with one
all-reduce over their shards, the same on every rank, so every rank clips
and skips alike.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from ..parallel.fsdp import is_sharded, local


def build_optimizers(cfg: dict,
                     params_by_module: Dict[str, Dict[str, torch.Tensor]]
                     ) -> Dict[str, torch.optim.Optimizer]:
    """One AdamW per submodule from the configs' ``{submodule: dict(
    type='AdamW', lr=..., betas=..., eps=..., weight_decay=...,
    paramwise_cfg=...)}`` over ``{submodule: {name: parameter}}``. The
    defaults are optax's and torch's alike (betas (0.9, 0.999), eps 1e-8,
    weight_decay 0.01). A parameter takes the lr_mult of the first of the
    sorted ``custom_keys`` its name contains."""
    out = {}
    for k, sub_cfg in cfg.items():
        if k not in params_by_module:
            raise KeyError(f'optimizer config references unknown submodule '
                           f'"{k}"; have {sorted(params_by_module)}')
        sub_cfg = dict(sub_cfg)
        if sub_cfg.pop('type') != 'AdamW':
            raise ValueError(f'only AdamW is ported, not {cfg[k]["type"]}')
        paramwise = sub_cfg.pop('paramwise_cfg', None) or {}
        custom_keys = dict(paramwise.get('custom_keys', {}))
        keys = sorted(custom_keys)
        groups: Dict[str, List[torch.Tensor]] = {}
        for name, p in params_by_module[k].items():
            label = next((c for c in keys if c in name), None)
            groups.setdefault(label, []).append(p)
        param_groups = [
            dict(params=ps, lr=sub_cfg['lr'] * (
                1.0 if label is None
                else custom_keys[label].get('lr_mult', 1.0)))
            for label, ps in groups.items()]
        if 'betas' in sub_cfg:
            sub_cfg['betas'] = tuple(sub_cfg['betas'])
        out[k] = torch.optim.AdamW(param_groups, **sub_cfg)
    return out


@dataclasses.dataclass(frozen=True)
class GradClipConfig:
    """Per-submodule clip policy (``train_cfg`` keys ``{k}_grad_clip``,
    ``{k}_grad_clip_begin_iter``, ``{k}_grad_clip_skip_ratio``)."""
    max_norm: float = 0.0
    begin_iter: int = 0
    skip_ratio: float = 0.0

    @classmethod
    def from_train_cfg(cls, train_cfg: dict, key: str) -> 'GradClipConfig':
        return cls(
            max_norm=train_cfg.get(f'{key}_grad_clip', 0.0),
            begin_iter=train_cfg.get(f'{key}_grad_clip_begin_iter', 0),
            skip_ratio=train_cfg.get(f'{key}_grad_clip_skip_ratio', 0.0))


def global_norm(tensors: List[torch.Tensor], counted=None) -> torch.Tensor:
    """L2 norm over all elements of all tensors, in fp32. Over sharded
    tensors (one mesh, sharded on its ``fsdp`` dimension, replicated on
    ``data``): the squared norms of this rank's shards summed over the
    ``fsdp`` group in one all-reduce, the same value on every rank. With
    ``counted`` (a mask over ``tensors`` and a process group: a model
    placed on ``pipe`` / ``expert`` axes, ``parallel/model_parallel.py``,
    or split over ``tensor``, ``parallel/tensor.py``): the squared norms
    of the tensors this rank counts (of its shards of them, under FSDP2),
    summed over the group."""
    if counted is not None:
        mask, group = counted
        sq = torch.stack([torch.linalg.vector_norm(local(t).float()) ** 2
                          for t, c in zip(tensors, mask) if c]
                         or [tensors[0].new_zeros((), dtype=torch.float32)]
                         ).sum()
        if group is not None:
            dist.all_reduce(sq, group=group)
        return torch.sqrt(sq)
    if not any(is_sharded(t) for t in tensors):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t.float()) for t in tensors]))
    mesh = next(t for t in tensors if is_sharded(t)).device_mesh
    sq = torch.stack([torch.linalg.vector_norm(local(t).float()) ** 2
                      for t in tensors]).sum()
    dist.all_reduce(sq, group=mesh.get_group('fsdp'))
    return torch.sqrt(sq)


@torch.no_grad()
def clip_and_skip(grads: List[torch.Tensor], iteration: int,
                  cfg: GradClipConfig, counted=None
                  ) -> Tuple[List[torch.Tensor], torch.Tensor, bool]:
    """Clip ``grads`` in place to ``max_norm`` (from ``begin_iter`` on) and
    zero their non-finite entries, so an optimizer never ingests a NaN.
    Returns (grads, norm before clipping, skip); skip is True when the norm
    is not finite or passes ``max_norm * skip_ratio``. ``counted`` as for
    ``global_norm``."""
    gnorm = global_norm(grads, counted)
    grads = [local(g) for g in grads]
    skip = not bool(torch.isfinite(gnorm))
    if cfg.max_norm > 0.0 and iteration >= cfg.begin_iter:
        scale = torch.clamp(cfg.max_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        torch._foreach_mul_(grads, scale)
        if cfg.skip_ratio > 0.0:
            skip = skip or bool(gnorm > cfg.max_norm * cfg.skip_ratio)
    for g in grads:
        g.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
    return grads, gnorm, skip
