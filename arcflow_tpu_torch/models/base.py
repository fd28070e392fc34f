"""Model composition base.

Counterpart of ``arcflow_tpu/models/base.py:BaseModel``. The JAX
composition owns static module definitions and takes its parameters in every
call; here the submodules hold their parameters, ``init_params`` hands out
the live (trainable, frozen) split as {submodule: {name: tensor}}, and
``loss`` draws its randomness from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


class BaseModel:
    """Base composition: subclasses build submodules and define the loss."""

    def __init__(self, train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})

    def init_params(self) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                   Dict[str, Dict[str, torch.Tensor]]]:
        """(trainable, frozen) as {submodule: {parameter name: tensor}}: the
        tensors the modules compute with, not copies."""
        raise NotImplementedError

    def loss(self, batch: dict, generator: torch.Generator,
             running_status: Optional[dict] = None):
        """(loss, log_vars) of one batch; the loss is differentiable in the
        trainable parameters."""
        raise NotImplementedError

    @property
    def ema_keys(self) -> Tuple[str, ...]:
        """Trainable submodule keys that keep an EMA copy."""
        return ()
