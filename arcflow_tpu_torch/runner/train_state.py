"""Training state: what one train step reads and updates.

Counterpart of ``arcflow_tpu/runner/train_state.py:TrainState``. The JAX
state is an immutable pytree returned anew by every step; here the step
updates it in place (parameters, optimizer state and EMA are large, and
PyTorch optimizers update their tensors in place):

* ``trainable`` {submodule: {name: parameter}}: the live tensors the
  optimizers update;
* ``frozen`` {submodule: {name: tensor}}: the shared trunk and the
  teacher's head, never written;
* ``ema`` {submodule: {name: tensor}}: fp32 copies of ``trainable``;
* ``opt_states`` {submodule: the optimizer's per-parameter state};
* ``generator``: every random draw of the step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: Dict[str, Dict[str, torch.Tensor]]
    frozen: Dict[str, Dict[str, torch.Tensor]]
    ema: Optional[Dict[str, Dict[str, torch.Tensor]]]
    opt_states: Dict[str, Any]
    generator: torch.Generator

    @classmethod
    def create(cls, generator: torch.Generator,
               trainable: Dict[str, Dict[str, torch.Tensor]],
               frozen: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
               optimizers: Optional[Dict[str, torch.optim.Optimizer]] = None,
               ema_keys: tuple = ()) -> 'TrainState':
        opt_states = {k: tx.state for k, tx in (optimizers or {}).items()}
        ema = {k: {n: p.detach().clone() for n, p in trainable[k].items()}
               for k in ema_keys} or None
        return cls(step=0, trainable=trainable, frozen=frozen or {}, ema=ema,
                   opt_states=opt_states, generator=generator)


def count_params(tree: Dict[str, Dict[str, torch.Tensor]]) -> int:
    return sum(t.numel() for sub in tree.values() for t in sub.values())
