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
* ``optimizers`` {submodule: its optimizer}, and ``opt_states``
  {submodule: that optimizer's per-parameter state}, read from the
  optimizers on each access, so it stays the live state after an
  ``optimizer.load_state_dict`` (a checkpoint restore);
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
    optimizers: Dict[str, torch.optim.Optimizer]
    generator: torch.Generator

    @property
    def opt_states(self) -> Dict[str, Any]:
        return {k: tx.state for k, tx in self.optimizers.items()}

    @classmethod
    def create(cls, generator: torch.Generator,
               trainable: Dict[str, Dict[str, torch.Tensor]],
               frozen: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
               optimizers: Optional[Dict[str, torch.optim.Optimizer]] = None,
               ema_keys: tuple = ()) -> 'TrainState':
        ema = {k: {n: p.detach().clone() for n, p in trainable[k].items()}
               for k in ema_keys} or None
        return cls(step=0, trainable=trainable, frozen=frozen or {}, ema=ema,
                   optimizers=dict(optimizers or {}), generator=generator)


def count_params(tree: Dict[str, Dict[str, torch.Tensor]]) -> int:
    return sum(t.numel() for sub in tree.values() for t in sub.values())
