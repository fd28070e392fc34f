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
* a quantized trunk's int8 / int4 kernels and their scales are buffers
  (``utils/quantize.py``), which FSDP2 does not shard; torch 2.11's FSDP2
  cannot hold an integer parameter either (it makes every sharded
  parameter with ``requires_grad=True``, which an int8 tensor refuses).
  ``_QuantShards`` shards them as FSDP2 shards a parameter: each becomes a
  ``DTensor`` of this rank's chunk of its outermost dimension in memory
  (``torch.chunk``'s split, laid in one flat byte buffer per unit), so a
  rank holds 1 / fsdp of the trunk's bytes and the checkpoint gathers and
  restores them as it does the parameters. The unit's forward gathers them
  whole, in their own layout, in one all-gather of those bytes over
  ``fsdp``, started while the unit before it computes, and puts its shards
  back after it (a checkpointed block's recompute gathers again; the
  dequantized weight its backward needs is a tensor of its own). A tied
  teacher runs the student's modules, so its trunk is sharded once. Under
  ``tensor`` a shard is a shard of this rank's tensor part (int4 cut at
  scale-group boundaries first);
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

import math
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.quantize import QUANT_NAMES

_ALIGN = 16             # bytes: every shard's offset in a unit's buffer


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


class _Prefetch:
    """Starts the next unit's quantized all-gather while this one
    computes, as FSDP2 does for its own. The units of a denoiser are
    numbered in the order of their first gather (a forward's); a gather
    guesses the next unit by going on in the direction of the last step:
    forward in a forward, backward in the recompute of checkpointed
    blocks. Only the very next gather may use what was started, and only
    if its shards did not change since (a restore writes them), so at
    most one unit waits gathered; a wrong guess costs one gather. Every
    rank of the group gathers in the same order, so they guess alike."""

    def __init__(self):
        self.units: List[_QuantShards] = []
        self.last = None
        self.pending = None

    def gather(self, unit: '_QuantShards') -> torch.Tensor:
        """``unit``'s gathered bytes (n x its flat size), waited on."""
        if unit.index is None:
            unit.index = len(self.units)
            self.units.append(unit)
        got, started = None, self.pending
        self.pending = None
        if started is not None:
            other, work, out, version = started
            work.wait()
            if other is unit and version == unit.flat._version:
                got = out
        if got is None:
            work, got = unit.start()
            work.wait()
        i = unit.index
        step = i - self.last if self.last is not None \
            and abs(i - self.last) == 1 else 1
        self.last = i
        if 0 <= i + step < len(self.units):
            nxt = self.units[i + step]
            self.pending = (nxt, *nxt.start(), nxt.flat._version)
        return got


class _QuantShards:
    """The quantized buffers of one FSDP2 unit (``owners``: (module, name)
    pairs), sharded over the shard dimension of the unit's 2-D ``mesh``,
    each along its outermost dimension in memory (dim 1 of a column-major
    int8 kernel, dim 0 of a row-major tensor; dimensions of size 1 last),
    so that a rank's part is one contiguous run. Rank r of n holds [r c,
    (r + 1) c) of that dimension's d, c = ceil(d / n) (none past d), padded
    to c in the unit's flat byte buffer, each tensor's segment aligned to
    ``_ALIGN`` bytes; the module's buffer is a ``DTensor`` whose local
    part is a view of it. ``gather`` (the unit's forward pre-hook) puts
    each tensor back whole, in the layout it had, and ``release`` (its
    forward hook, called also when the forward stops early, as a
    checkpoint's recompute does) its ``DTensor``."""

    def __init__(self, owners: List[Tuple[nn.Module, str]],
                 mesh: DeviceMesh, prefetch: _Prefetch):
        self.owners, self.prefetch, self.index = owners, prefetch, None
        self.group = mesh.get_group(mesh.ndim - 1)
        n, r = mesh.size(mesh.ndim - 1), mesh.get_local_rank(mesh.ndim - 1)
        self.n = n
        self.meta, offset = [], 0
        for m, name in owners:
            t = m._buffers[name]
            perm = sorted(range(t.dim()), key=lambda i: (t.shape[i] > 1,
                                                          t.stride(i)),
                          reverse=True)
            if not t.permute(perm).is_contiguous():
                perm = list(range(t.dim()))
            d = t.shape[perm[0]]
            c = math.ceil(d / n)
            row = t.numel() // d * t.element_size() if d else 0
            rows = [max(0, min(c, d - i * c)) for i in range(n)]
            self.meta.append((t.shape, t.dtype, perm, row, offset, rows))
            offset += -(-c * row // _ALIGN) * _ALIGN
        self.flat = torch.zeros(offset, dtype=torch.uint8,
                                device=owners[0][0]._buffers[
                                    owners[0][1]].device)
        self.sharded = []
        with torch.no_grad():
            for (m, name), (shape, dtype, perm, row, off, rows) in zip(
                    owners, self.meta):
                t = m._buffers[name].permute(perm)
                mine = rows[r]
                part = self.flat[off:off + mine * row].view(dtype).view(
                    mine, *t.shape[1:])
                part.copy_(t[r * rows[0]:r * rows[0] + mine])
                d = DTensor.from_local(
                    part.permute(_inverse(perm)), mesh,
                    [Replicate(), Shard(perm[0])], run_check=False,
                    shape=shape,
                    stride=torch.empty(shape, device='meta').stride())
                m._buffers[name] = d
                self.sharded.append(d)

    def start(self):
        """(work, gathered bytes): this unit's all-gather, started."""
        out = self.flat.new_empty(self.n * self.flat.numel())
        return dist.all_gather_into_tensor(out, self.flat, group=self.group,
                                           async_op=True), out

    def gather(self, *_):
        out = self.prefetch.gather(self).view(self.n, -1)
        for (m, name), (shape, dtype, perm, row, off, rows) in zip(
                self.owners, self.meta):
            whole = torch.cat([out[i, off:off + k * row]
                               for i, k in enumerate(rows)]).view(dtype)
            m._buffers[name] = whole.view(
                [shape[i] for i in perm]).permute(_inverse(perm))

    def release(self, *_):
        for (m, name), d in zip(self.owners, self.sharded):
            m._buffers[name] = d


def _inverse(perm):
    return sorted(range(len(perm)), key=perm.__getitem__)


def _shard_quantized(unit: nn.Module, mesh: DeviceMesh, taken: set,
                     prefetch: _Prefetch) -> None:
    """``_QuantShards`` over ``unit``'s quantized buffers that no unit
    inside it took (``taken``: the ids of the modules already placed),
    with the unit's forward hooks."""
    owners = []
    for m in unit.modules():
        if id(m) in taken:
            continue
        taken.add(id(m))
        owners += [(m, n) for n in QUANT_NAMES
                   if isinstance(m._buffers.get(n), torch.Tensor)
                   and not is_sharded(m._buffers[n])]
    if owners:
        shards = _QuantShards(owners, mesh, prefetch)
        unit.register_forward_pre_hook(shards.gather)
        unit.register_forward_hook(shards.release, always_call=True)


def shard_units(denoiser: nn.Module, mesh: DeviceMesh) -> None:
    """Make FSDP2 units of ``denoiser`` (``_units``: its blocks, its other
    children, itself) over the 2-D (replicate, shard) ``mesh``, in place,
    its quantized buffers sharded with them (``_QuantShards``, gathered
    ahead by one ``_Prefetch``); a unit that is one already (a module
    shared with a denoiser sharded before) is left as it is. Every unit
    reshards after its forward, the outermost too: a unit that runs
    outside the loss (an evaluation, or a serving call where the denoiser
    is the root) would otherwise keep its gathered parameters."""
    taken, prefetch = set(), _Prefetch()
    for unit in _units(denoiser):
        if isinstance(unit, FSDPModule):
            taken.update(id(m) for m in unit.modules())
            continue
        fully_shard(unit, mesh=mesh, reshard_after_forward=True)
        _shard_quantized(unit, mesh, taken, prefetch)


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
        shard_units(denoiser, mesh)
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
