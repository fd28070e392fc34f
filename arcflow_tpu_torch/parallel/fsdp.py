"""Parameter sharding over the ``fsdp`` axis, replicated over ``data``
(FSDP2 ``fully_shard`` on a 2-D ``DeviceMesh``, i.e. HSDP).

Counterpart of ``shard_state`` / ``fsdp_spec_for`` / ``param_spec_for``
(``arcflow_tpu/parallel/mesh.py:113-150, 210-240``). JAX places each array
of the train state on the mesh and lets GSPMD insert the all-gathers and
reduce-scatters; here FSDP2 does that per unit of modules:

* every block of a transformer (each item of a ``ModuleList``: the joint,
  single and Qwen blocks, each a checkpointed unit), every other child
  module of a denoiser, and the denoiser itself (what is left of it) is
  one unit: its parameters are sharded on dim 0 over ``fsdp``, gathered
  before its forward and again in the backward, and its gradients are
  reduce-scattered over ``fsdp`` and averaged over ``data``. The frozen
  trunk is sharded with the rest, as JAX shards ``TrainState.frozen``;
* FSDP2 gathers a unit's parameters in one collective, so a small
  parameter costs no collective of its own, and every parameter is
  sharded: JAX's ``min_shard_size`` (the smallest array it cuts) does not
  apply. The results, not the placement, are the JAX package's;
* buffers (the int8 / int4 kernels of a quantized trunk) are not FSDP2's
  to shard: they stay whole on every rank;
* the parameters, and so the ``TrainState`` dicts, the AdamW slots and the
  EMA made from them, become ``DTensor``s; ``local`` gives the shard a
  rank holds, ``shard_of`` cuts a rank's shard out of a full tensor.

The composition's loss becomes the forward of one root module over every
unit (``model.loss`` is replaced by the root's call): FSDP2 finds its units
from the first root to run forward.

Under ``sp`` (a 3-D ('data', 'fsdp', 'sp') mesh): the parameters are
sharded over ``fsdp`` and replicated over ``data`` x ``sp`` (FSDP2's
2-D mesh of ``fsdp_mesh``), and the ranks of one sp group run the same
rows. The trunk's blocks run on token shards; the embedders of the
replicated inputs (timestep, guidance, pooled text), the heads and the
loss run replicated, after the gather. The convention that makes each
token count exactly once:

* every rank backpropagates the whole loss (the same on each rank);
* ``SequenceParallel.gather``'s backward is a reduce-scatter (a sum), so
  a token shard's gradient is n_sp x its share of the true one, as is
  every block parameter's gradient on a rank, while a replicated
  tensor's gradient (the heads', and the head's part of the timestep
  embedding's) is the true one on every rank;
* FSDP2 averages the gradients over ``data``, ``fsdp`` and ``sp`` alike,
  so over an sp group it takes the mean: the heads' true gradient, and
  for the blocks and the timestep embedder (which feeds both the sharded
  blocks and the replicated head) the head's part plus the sum of the
  shards' parts.

This is the same as a loss scaled by 1 / n_sp and gradients summed over
``sp``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import DTensor


def is_sharded(t) -> bool:
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The part of ``t`` this rank holds: a ``DTensor``'s local shard (a
    view: writing to it writes to ``t``), any other tensor itself."""
    return t.to_local() if is_sharded(t) else t


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full``, laid out as the live tensor ``like``:
    for a ``DTensor`` the chunk of each sharded dimension at this rank's
    mesh coordinate (``torch.chunk``'s split, FSDP2's and DTensor's);
    for any other tensor ``full`` itself."""
    if not is_sharded(like):
        return full
    mesh = like.device_mesh
    x = full
    for dim, placement in enumerate(like.placements):
        if placement.is_shard():
            chunks = x.chunk(mesh.size(dim), dim=placement.dim)
            i = mesh.get_local_rank(dim)
            x = chunks[i] if i < len(chunks) \
                else x.narrow(placement.dim, 0, 0)
    return x


def _units(denoiser: nn.Module):
    """The modules ``shard_model`` makes FSDP2 units of, inner first: the
    items of every ``ModuleList`` child (the blocks), every other child
    that holds parameters, then the denoiser itself."""
    for child in denoiser.children():
        if isinstance(child, nn.ModuleList):
            yield from (m for m in child if any(True for _ in m.parameters()))
        elif any(True for _ in child.parameters()):
            yield child
    yield denoiser


class _LossRoot(nn.Module):
    """The FSDP2 root: runs the composition's loss as its forward, so one
    root holds every unit of the modules the loss runs."""

    def __init__(self, loss, modules: Dict[str, nn.Module]):
        super().__init__()
        self.parts = nn.ModuleDict(modules)
        self._loss = loss

    def forward(self, batch, generator, running_status=None):
        return self._loss(batch, generator, running_status=running_status)


def fsdp_mesh(mesh):
    """FSDP2's 2-D (replicate, shard) mesh for ``make_mesh``'s mesh: the
    ('data', 'fsdp') mesh itself; for a ('data', 'fsdp', 'sp') mesh one
    whose replicated dimension ('data_sp') runs over data x sp; for a
    ('data', 'fsdp', 'tensor') mesh the ('data', 'fsdp') mesh of this
    rank's tensor coordinate, since the ranks at different tensor
    coordinates hold different parts (``parallel/tensor.py``): an fsdp
    shard is a shard of this rank's tensor part, as JAX's combined TP +
    ZeRO-3 spec has it."""
    if 'tensor' in mesh.mesh_dim_names:
        return mesh['data', 'fsdp']
    if 'sp' not in mesh.mesh_dim_names:
        return mesh
    d, f, n = mesh.mesh.shape
    return DeviceMesh(mesh.device_type,
                      mesh.mesh.permute(0, 2, 1).reshape(d * n, f),
                      mesh_dim_names=('data_sp', 'fsdp'))


def shard_model(model, mesh) -> None:
    """Shard the modules of ``model`` (a composition) that its loss runs
    (``model.fsdp_modules()``: the student's and the teacher's denoisers)
    over ``mesh`` (``make_mesh``'s ('data', 'fsdp') ``DeviceMesh``, or its
    ('data', 'fsdp', 'sp') one, through ``fsdp_mesh``), in place. A
    module shared by two denoisers (the tied teacher's trunk) is
    sharded once. Call it before ``model.init_params()``, which then hands
    out the sharded parameters. ``model.loss`` becomes the call of the
    root module."""
    mesh = fsdp_mesh(mesh)
    modules = model.fsdp_modules()
    for denoiser in modules.values():
        for unit in _units(denoiser):
            if not isinstance(unit, FSDPModule):
                # a unit that runs before the loss (an evaluation) would be
                # FSDP2's root, which by default keeps its gathered
                # parameters after its forward
                fully_shard(unit, mesh=mesh, reshard_after_forward=True)
    root = _LossRoot(model.loss, modules)
    fully_shard(root, mesh=mesh)
    model.loss = root


def gradient_sync(model, on: bool) -> None:
    """FSDP2's reduction of the gradients (reduce-scatter over ``fsdp``,
    all-reduce over ``data``) on or off for every unit of ``model``, a
    composition that ``shard_model`` sharded. Off, each rank accumulates
    its unsharded gradients locally, as gradient accumulation does before
    its last micro-batch."""
    model.loss.set_requires_gradient_sync(on)
