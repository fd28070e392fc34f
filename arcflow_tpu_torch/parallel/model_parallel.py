"""A model placed on the ``pipe`` and ``expert`` axes of a training mesh,
and what a train step and a checkpoint need of that placement.

Counterpart of the ``pipe`` / ``expert`` rules of JAX ``shard_state``
(``arcflow_tpu/parallel/mesh.py:param_spec_for_path``: ``stacked_param_
spec`` puts a stacked block leaf's layer dim on ``pipe``, ``moe_param_spec``
an expert leaf's expert dim on ``expert``). Weights never move:

* a block of a stack the pipe degree S divides is held by the stage that
  runs it (``pipeline.layer_stage``: the contiguous L / S blocks of stage
  s, or its strided chunks under the circular schedule); on every other
  rank its parameters and buffers (a quantized trunk's int8 / int4
  kernels, JAX ``svars['quant']``) are emptied to 0 elements, so its
  memory is freed. A stack S does not divide stays on every rank, as JAX
  keeps it whole on ``pipe``;
* an MoE layer's expert leaves (``w_in``, ``b_in``, ``w_out``, ``b_out``)
  keep this rank's E / n experts (``MoEFeedForward.partition_experts``).
  JAX's spec also puts the router's D dim on ``expert``, a placement of
  its storage only; the port keeps the (D, E) router whole, as its math
  needs all of it on every rank;
* everything else is replicated on every rank.

Every rank keeps every tensor name of the one-device model (a tensor it
does not hold is empty), so the optimizers, built from the same names,
index their parameters as on one device. The step (``runner/
train_step.py``) averages the gradients over ``data`` only
(``reduce_gradients``; a replicated parameter gets the same gradient on
every rank of a pipe / expert group, see ``parallel/pipeline.py`` and
``parallel/expert.py``), and takes the global norm over every stage and
expert, each tensor counted once (``counted``). A checkpoint holds the
one-device layout (``gather_full``; rank 0 writes it) and restores onto
this mesh, another or none (``local_part``).

``fsdp`` > 1 beside ``pipe`` or ``expert`` (JAX also shards the remaining
dims over ``fsdp``) and ``sp`` beside them are refused by name (ROADMAP.md
queue A items 5.10 and 5.8).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .expert import ExpertParallel
from .mesh import FSDP_WITH_MODEL_AXES, MODEL_AXES
from .pipeline import PipeGroup, layer_stage, set_pipe

# the stacks a pipe stage splits, as ``pipelines/convert.py:STACKED``
STACKS = ('joint_blocks', 'single_blocks', 'transformer_blocks')
EXPERT_LEAVES = ('w_in', 'b_in', 'w_out', 'b_out')
_STACKED = re.compile(r'^(%s)\.(\d+)\.' % '|'.join(STACKS))


@dataclasses.dataclass(frozen=True)
class Place:
    """Where a tensor of the one-device model lives: ``stage`` holds it
    (None: every stage); ``expert``: its dim 0 is split over the expert
    group."""
    stage: Optional[int]
    expert: bool


def _new_groups(grid: torch.Tensor) -> dist.ProcessGroup:
    """One process group per row of ``grid`` (n, k), this rank's; every
    rank creates every group, as ``new_group`` requires."""
    me, mine = dist.get_rank(), None
    for row in grid.tolist():
        g = dist.new_group(row)
        if me in row:
            mine = g
    return mine


class ModelParallel:
    """This rank's place on a mesh with ``pipe`` and / or ``expert`` axes
    (``make_mesh``'s ``DeviceMesh``), the model's stack depths and the
    full shapes of its tensors."""

    def __init__(self, mesh, microbatches: Optional[int] = None,
                 interleave: int = 1):
        names = mesh.mesh_dim_names
        if mesh.size(names.index('fsdp')) > 1:
            raise NotImplementedError(
                f'fsdp > 1 beside {[a for a in MODEL_AXES if a in names]} is '
                f'not ported yet (ROADMAP.md queue A item '
                f'{FSDP_WITH_MODEL_AXES}): set fsdp to 1, or leave pipe and '
                f'expert out')
        self.mesh = mesh
        coord = dict(zip(names, mesh.get_coordinate()))
        self.pipe = PipeGroup(mesh.get_group('pipe'), microbatches,
                              interleave) if 'pipe' in names else None
        self.expert = ExpertParallel(mesh.get_group('expert')) \
            if 'expert' in names else None
        self.pipe_rank = coord.get('pipe', 0)
        self.expert_rank = coord.get('expert', 0)
        self.data_group = mesh.get_group('data') \
            if mesh.size(names.index('data')) > 1 else None
        grid = mesh.mesh
        model_dims = [names.index(a) for a in MODEL_AXES if a in names]
        rest = [d for d in range(grid.dim()) if d not in model_dims]
        grid = grid.permute(rest + model_dims).reshape(
            -1, grid[tuple([0] * len(rest))].numel())
        self.model_group = _new_groups(grid) if grid.shape[1] > 1 else None
        self.stacks: Dict[str, int] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}

    # ---- placement ---------------------------------------------------------
    def place(self, name: str) -> Place:
        m = _STACKED.match(name)
        stage = None
        if m and self.pipe is not None:
            n = self.stacks.get(m.group(1), 0)
            if n and n % self.pipe.size == 0:
                stage = layer_stage(int(m.group(2)), n, self.pipe.size,
                                    self.pipe.interleave)
        expert = self.expert is not None and '.moe.' in f'.{name}' and \
            name.rsplit('.', 1)[-1] in EXPERT_LEAVES
        return Place(stage, expert)

    def holds(self, name: str) -> bool:
        stage = self.place(name).stage
        return stage is None or stage == self.pipe_rank

    def counted(self, name: str) -> bool:
        """Whether this rank counts ``name``'s tensor in a sum over the
        pipe x expert group: each tensor on one rank of it."""
        place = self.place(name)
        return (place.stage is None and self.pipe_rank == 0
                or place.stage == self.pipe_rank) and \
            (place.expert or self.expert_rank == 0)

    def rank_at(self, pipe: int, expert: int) -> int:
        """The global rank at (data 0, fsdp 0, ``pipe``, ``expert``)."""
        at = dict(pipe=pipe, expert=expert)
        return int(self.mesh.mesh[tuple(
            at.get(a, 0) for a in self.mesh.mesh_dim_names)])

    # ---- the state in the one-device layout --------------------------------
    def gather_full(self, name: str, t: torch.Tensor
                    ) -> Optional[torch.Tensor]:
        """The one-device tensor ``name`` of which ``t`` is this rank's part,
        on rank 0 (None elsewhere); every rank calls it for the same names
        in the same order. The holders send their parts to rank 0."""
        place = self.place(name)
        me = dist.get_rank()
        if place.stage is None and not place.expert:
            return t if me == 0 else None
        n_e = self.expert.size if place.expert else 1
        full = self.shapes[name]
        shape = (full[0] // n_e, *full[1:])
        parts = []
        for e in range(n_e):
            owner = self.rank_at(place.stage or 0, e)
            if owner == 0:
                part = t if me == 0 else None
            elif me == owner:
                dist.send(t.contiguous(), dst=0)
                part = None
            elif me == 0:
                part = torch.empty(shape, dtype=t.dtype, device=t.device)
                dist.recv(part, src=owner)
            else:
                part = None
            parts.append(part)
        if me != 0:
            return None
        return torch.cat(parts) if place.expert else parts[0]

    def local_part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the one-device tensor ``full`` of ``name``."""
        if not self.holds(name):
            return full.new_empty(0)
        if self.place(name).expert:
            lo, hi = self.expert.experts(full.shape[0])
            return full[lo:hi]
        return full

    # ---- the step ----------------------------------------------------------
    def reduce_gradients(self, params: Iterable[torch.Tensor]) -> None:
        """Average the gradients over ``data`` (one all-reduce per dtype)."""
        if self.data_group is None:
            return
        grads = {}
        for p in params:
            if p.numel() == 0:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.setdefault(p.grad.dtype, []).append(p.grad)
        n = dist.get_world_size(self.data_group)
        for gs in grads.values():
            flat = torch._utils._flatten_dense_tensors(gs)
            dist.all_reduce(flat, group=self.data_group)
            flat /= n
            for g, r in zip(gs, torch._utils._unflatten_dense_tensors(
                    flat, gs)):
                g.copy_(r)


def partition_model(model, mesh, microbatches: Optional[int] = None,
                    interleave: int = 1) -> ModelParallel:
    """Place ``model`` (a composition, or a denoiser) on ``mesh``'s
    ``pipe`` and ``expert`` axes, in place: its denoisers (the student and
    the teacher, ``fsdp_modules``) get the pipe state and their MoE layers
    the expert state, and what this rank does not hold is freed. Call it
    before ``model.init_params()``. Sets and returns
    ``model.model_parallel``."""
    mp = ModelParallel(mesh, microbatches, interleave)
    roots = [model] if isinstance(model, nn.Module) \
        else list(model.fsdp_modules().values())
    from ..models.layers import MoEFeedForward
    seen = set()
    for root in roots:
        for name, t in (*root.named_parameters(), *root.named_buffers()):
            mp.shapes.setdefault(name, tuple(t.shape))
        for stack in STACKS:
            if isinstance(getattr(root, stack, None), nn.ModuleList):
                mp.stacks[stack] = len(getattr(root, stack))
        if mp.pipe is not None:
            set_pipe(root, mp.pipe)
        for m in root.modules():
            if isinstance(m, MoEFeedForward) and mp.expert is not None \
                    and id(m) not in seen:
                seen.add(id(m))
                m.partition_experts(mp.expert)
        for stack in mp.stacks:
            blocks = getattr(root, stack, None)
            for i, block in enumerate(blocks or ()):
                if not mp.holds(f'{stack}.{i}.') and id(block) not in seen:
                    seen.add(id(block))
                    _free(block)
    model.model_parallel = mp
    return mp


def _free(module: nn.Module) -> None:
    """Empty every parameter and buffer of ``module`` (0 elements)."""
    with torch.no_grad():
        for m in module.modules():
            for p in m._parameters.values():
                if p is not None:
                    p.data = p.data.new_empty(0)
            for k, b in m._buffers.items():
                if b is not None:
                    m._buffers[k] = b.new_empty(0)


def model_axes(mesh) -> List[str]:
    """The model-parallel axes of ``make_mesh``'s mesh."""
    return [a for a in MODEL_AXES
            if mesh is not None and a in mesh.mesh_dim_names]
