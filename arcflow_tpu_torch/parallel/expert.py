"""Expert parallelism over an ``expert`` axis.

Counterpart of the ``expert`` placement of ``arcflow_tpu/parallel/mesh.py:
346 moe_param_spec`` and of the ``'experts'`` activation constraint of
``arcflow_tpu/models/layers.py:MoEFeedForward``. JAX shards the expert
dimension of the MoE weights over ``expert`` and lets GSPMD reduce the
combine contraction; here each rank of an ``expert`` group holds E / n of
the experts (``ExpertParallel.experts``) and runs them on the rows it holds,
which every rank of the group holds alike (the batch splits over ``data``
x ``fsdp`` only). Two autograd functions make the rest exact:

* ``replicate`` is the identity forward and sums its gradient over the
  group backward: the router scores and the tokens enter the experts so,
  each rank differentiating only through its own experts, and every rank
  gets the whole gradient of the router and of the block's input;
* ``combine`` sums the ranks' partial outputs forward (one all-reduce)
  and passes the gradient through backward: the loss downstream runs alike
  on every rank of the group, so each holds the whole gradient of the
  output already.

An expert's own weights therefore get their true gradient on the one rank
that holds them, and a weight replicated over the group the same gradient
on each rank, so it stays the same everywhere.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


class ExpertParallel:
    """This rank's place in an ``expert`` group of ``dist.ProcessGroup``
    ``group``."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def experts(self, num_experts: int) -> Tuple[int, int]:
        """[first, last) of the ``num_experts`` experts this rank holds:
        the rank's contiguous block, as ``P('expert')`` places them."""
        if num_experts % self.size:
            raise ValueError(f'{num_experts} experts do not split over '
                             f'{self.size} expert ranks')
        n = num_experts // self.size
        return self.rank * n, (self.rank + 1) * n

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        return _Replicate.apply(x, self.group)

    def combine(self, x: torch.Tensor) -> torch.Tensor:
        return _Combine.apply(x, self.group)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None
