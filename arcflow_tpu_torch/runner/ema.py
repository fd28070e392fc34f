"""Exponential moving average of the trainable parameters, run at the end
of each train step.

Counterpart of ``arcflow_tpu/runner/ema.py`` for lerp with an update every
iteration: Karras momentum ``beta = (1 - 1/t)^(gamma + 1)``,
``t = iter + 1 - start_iter`` (what every config sets), or a fixed
``momentum`` (the JAX trainer's default without an EMA hook);
copy-through before ``start_iter``. The EMA tensors are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class EmaConfig:
    gamma: float = 7.0    # karras exponent
    start_iter: int = 0
    momentum_policy: str = 'karras'    # 'karras' | 'fixed'
    momentum: float = 0.999            # the 'fixed' policy's beta

    @classmethod
    def from_hook_cfg(cls, hook_cfg: dict) -> 'EmaConfig':
        """From a reference-style ExponentialMovingAverageHookMod config.
        Only lerp, karras momentum, interval 1 and max_momentum 1 are
        ported; any other value raises."""
        m_cfg = hook_cfg.get('momentum_cfg', {}) or {}
        for key, got, want in (
                ('interp_mode', hook_cfg.get('interp_mode', 'lerp'), 'lerp'),
                ('momentum_policy', hook_cfg.get('momentum_policy', 'fixed'),
                 'karras'),
                ('interval', hook_cfg.get('interval', 1), 1),
                ('max_momentum', m_cfg.get('max_momentum', 1.0), 1.0)):
            if got != want:
                raise ValueError(f'unsupported EMA {key} {got!r}: only '
                                 f'{want!r} is ported')
        return cls(gamma=m_cfg.get('gamma', 7.0),
                   start_iter=hook_cfg.get('start_iter', 0))


def ema_momentum(cfg: EmaConfig, iteration: int) -> float:
    """Momentum beta at ``iteration``: the fixed one, or Karras'."""
    if cfg.momentum_policy == 'fixed':
        return cfg.momentum
    t = float(max(iteration + 1 - cfg.start_iter, 1))
    return (1.0 - 1.0 / t) ** (cfg.gamma + 1.0)


@torch.no_grad()
def ema_update(cfg: EmaConfig, ema_params: Dict[str, torch.Tensor],
               new_params: Dict[str, torch.Tensor], iteration: int
               ) -> Dict[str, torch.Tensor]:
    """One EMA step on ``ema_params``, in place: a copy of ``new_params``
    before ``start_iter``, ``e * beta + p * (1 - beta)`` after."""
    es = list(ema_params.values())
    ps = [new_params[k].detach().to(e.dtype) for k, e in ema_params.items()]
    if iteration < cfg.start_iter:
        torch._foreach_copy_(es, ps)
    else:
        beta = ema_momentum(cfg, iteration)
        torch._foreach_mul_(es, beta)
        torch._foreach_add_(es, ps, alpha=1.0 - beta)
    return ema_params
