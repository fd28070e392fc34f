"""Tensor (Megatron-style) parallelism over a ``tensor`` axis.

Counterpart of the ``tensor`` rule of ``arcflow_tpu/parallel/mesh.py``
(``param_spec_for`` 127-149, ``param_spec_for_path`` 180-207: the last dim
of every kernel over ``tensor``, combined with ZeRO-3 over ``fsdp``), of
``shard_activation``'s 'heads' / 'hidden' constraints (426-505) and of
``heads_partition`` (379-405), under which the Pallas flash kernel runs per
head shard. JAX lets GSPMD place the arrays and insert the collectives;
here the split is written out, with JAX's one-device math:

* q / k / v, an MLP's ``in_proj``, a single block's ``proj_mlp`` and the
  AdaLN modulations are *column* parallel: shard i of t holds the output
  columns ``part_ranges(segments, t, i)`` (H / t heads, F / t hidden
  units), its bias part and its LoRA B part; its LoRA A stays whole;
* the attention out projections, an MLP's ``out_proj`` and a single
  block's ``proj_out`` are *row* parallel: shard i holds the input rows
  of its heads and hidden units and its LoRA A part, and the shards'
  partial products are summed (one all-reduce, the LoRA branch's partial
  product joining it); the bias and LoRA B are added once, after it;
* a quantized layer is quantized whole first and then split, never
  re-quantized: a column split cuts the per-channel scales with the
  columns, a row split keeps the int8 (1, out) scale whole and cuts the
  int4 groups at group boundaries (``pack_int4`` is group-local). A row
  layer's per-token activation scale (w8a8, w4a8) is the absmax over the
  whole row, an all-reduce max over the shards (``all_max``), as JAX
  computes it over the full input row;
* the modulations' (B, 6D) / (B, 3D) outputs are gathered (``gather``),
  a few KB; the embedders, the ArcFlow heads and ``norm_out`` stay whole.

A single block's ``proj_out`` reads ``cat([attn_out, mlp_h])``: shard i's
rows are its heads' rows in [0, H hd) together with its hidden units' rows
in [H hd + i F / t, H hd + (i + 1) F / t): its ``segments`` are (H hd, F),
each cut in t (``part_ranges``), not one contiguous 1/t of the rows.

One code path, two transports, as ``LocalRing`` / ``ring_attention`` and
``LocalPipe`` / ``PipeGroup``:

* ``LocalTensor(t)``: every shard in this process. A layer keeps its
  one-device tensors and runs each shard's product at the shard's shape
  (the attention kernels on H / t heads, K5 on (K, N / t) and (K / t, N));
  the all-reduce is a sum in shard order. One card checks the schedule so;
* ``TensorGroup(group)``: shard ``rank`` of the mesh's ``tensor`` process
  group; a layer holds only its part (1 / t of the split layers' memory)
  and the collectives run over the group.

Differentiable, with Megatron's convention: the input of a column region
enters through ``enter`` (identity forward, the gradient summed over the
group backward), a row region leaves through ``reduce`` (the partial
outputs summed forward, the gradient passed through backward), and a
gathered modulation's backward keeps this shard's columns of its
gradient. Every rank of a tensor group runs the same rows and the same
replicated code, so a replicated parameter gets its whole gradient on
every rank and a split one its part's whole gradient: the gradients need
no reduction over ``tensor`` (``parallel/fsdp.py`` averages them over
``data`` x ``fsdp`` only), and the global norm sums a split tensor's
squares over the group and counts a replicated one once
(``TensorPlacement.counted``).

What stays refused, each by name with its ROADMAP.md queue A item:
``tensor`` beside ``sp`` in training (5.11), beside ``pipe`` or
``expert`` (5.12), and MoE blocks under ``tensor`` (JAX's
``experts_hidden`` split, 5.13).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..utils.quantize import _stack_len

# the ROADMAP.md queue A item of MoE blocks under tensor
MOE_UNDER_TENSOR = '5.13'

Ranges = List[Tuple[int, int]]


class LocalTensor:
    """The one-process schedule of ``size`` tensor shards."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f'tensor parallelism needs at least one shard, '
                             f'got {size}')
        self.size = size

    @property
    def parts(self) -> Sequence[int]:
        """The shards this process runs."""
        return range(self.size)

    @property
    def holds_parts(self) -> bool:
        """Whether a layer keeps only its shard (else its whole tensors)."""
        return False

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce(self, partials: List[torch.Tensor]) -> torch.Tensor:
        out = partials[0]
        for p in partials[1:]:
            out = out + p
        return out

    def gather(self, parts: List[torch.Tensor], dim: int = -1
               ) -> torch.Tensor:
        return torch.cat(parts, dim=dim)

    def all_max(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each shard's copy of the elementwise max over the shards."""
        m = xs[0]
        for x in xs[1:]:
            m = torch.maximum(m, x)
        return [m] * len(xs)


class TensorGroup(LocalTensor):
    """This rank's shard of the ``tensor`` process group ``group``."""

    def __init__(self, group: dist.ProcessGroup):
        super().__init__(dist.get_world_size(group))
        self.group = group
        self.rank = dist.get_rank(group)

    @property
    def parts(self) -> Sequence[int]:
        return (self.rank,)

    @property
    def holds_parts(self) -> bool:
        return True

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def reduce(self, partials: List[torch.Tensor]) -> torch.Tensor:
        (p,) = partials
        return _Reduce.apply(p, self.group)

    def gather(self, parts: List[torch.Tensor], dim: int = -1
               ) -> torch.Tensor:
        (p,) = parts
        return _GatherCols.apply(p, self, dim % p.dim())

    def all_max(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        (x,) = xs
        out = x.detach().contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return [out]


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(tp.size)]
        dist.all_gather(parts, x.contiguous(), group=tp.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n), None, None


# ---- index maps --------------------------------------------------------------

def part_ranges(segments: Sequence[int], size: int, i: int) -> Ranges:
    """(start, length) of shard ``i`` of ``size`` along a dim made of
    ``segments`` (lengths, in order): the i-th 1 / size of each segment."""
    out, start = [], 0
    for n in segments:
        if n % size:
            raise ValueError(f'a segment of {n} does not split over {size} '
                             f'tensor shards')
        out.append((start + i * (n // size), n // size))
        start += n
    return out


def take(x: torch.Tensor, dim: int, ranges: Ranges) -> torch.Tensor:
    """The rows of ``x`` along ``dim`` in ``ranges``, in order (a view
    where there is one range)."""
    if len(ranges) == 1:
        return x.narrow(dim, *ranges[0])
    return torch.cat([x.narrow(dim, s, n) for s, n in ranges], dim=dim)


def put(parts: List[torch.Tensor], dim: int, segments: Sequence[int]
        ) -> torch.Tensor:
    """The inverse of ``take`` over every shard: the whole tensor of which
    ``parts[i]`` is shard i."""
    size = len(parts)
    pieces = [[] for _ in segments]
    for p in parts:
        off = 0
        for j, n in enumerate(segments):
            pieces[j].append(p.narrow(dim, off, n // size))
            off += n // size
    return torch.cat([t for seg in pieces for t in seg], dim=dim)


# Where each tensor of a split ``LoRADense`` is cut, in its storage layout:
# name -> (dim, rows of the split dim per row of that tensor's dim), for a
# column split (over the output features) and a row split (over the input
# features). A tensor left out stays whole. ``kernel_packed4`` holds two
# input rows per row; ``kernel_scale4`` one per scale group (its unit is
# the group size, filled in per layer).
SPLIT_DIMS = {
    'column': {'weight': (0, 1), 'bias': (0, 1), 'lora_b': (1, 1),
               'kernel': (1, 1), 'kernel_scale': (1, 1),
               'kernel_packed4': (1, 1), 'kernel_scale4': (2, 1)},
    'row': {'weight': (1, 1), 'lora_a': (0, 1), 'kernel': (0, 1),
            'kernel_packed4': (0, 2), 'kernel_scale4': (0, None)},
}


def tensor_split_dim(kind: str, name: str, group_size: Optional[int] = None
                     ) -> Optional[Tuple[int, int]]:
    """(dim, unit) of tensor ``name`` of a ``kind`` split layer (None: the
    tensor stays whole); ``group_size`` is an int4 layer's."""
    spec = SPLIT_DIMS[kind].get(name)
    if spec is None:
        return None
    dim, unit = spec
    return dim, group_size if unit is None else unit


def split_part(t: torch.Tensor, name: str, kind: str,
               segments: Sequence[int], size: int, i: int,
               group_size: Optional[int] = None,
               view: bool = False) -> torch.Tensor:
    """Shard ``i`` of ``size`` of tensor ``name`` of a split layer, laid
    out as the layer keeps it (an int8 ``kernel`` column-major) in storage
    of its own, so that ``t``'s can be freed; with ``view`` as ``take``
    gives it (a view of ``t`` for one segment)."""
    spec = tensor_split_dim(kind, name, group_size)
    if spec is None:
        return t
    dim, unit = spec
    part = take(t, dim, part_ranges([n // unit for n in segments], size, i))
    if view:
        return part
    if name == 'kernel':
        return part.t().clone(memory_format=torch.contiguous_format).t()
    return part.clone(memory_format=torch.contiguous_format)


def join_parts(parts: List[torch.Tensor], name: str, kind: str,
               segments: Sequence[int], group_size: Optional[int] = None
               ) -> torch.Tensor:
    """The whole tensor ``name`` from every shard's part (``split_part``'s
    inverse)."""
    spec = tensor_split_dim(kind, name, group_size)
    if spec is None:
        return parts[0]
    dim, unit = spec
    full = put(parts, dim, [n // unit for n in segments])
    if name == 'kernel':
        return full.t().contiguous().t()
    return full


# ---- placing a model ------------------------------------------------------------

def _layer_ok(layer, kind: str, segments: Sequence[int], size: int,
              numel: int, min_size: int) -> bool:
    """Whether a ``LoRADense`` can be split ``kind`` over ``size`` shards:
    JAX's ``min_size`` (counted over a block stack, as JAX counts its
    scanned leaves), every segment divisible, and the parts in a form the
    kernels take (int8: 8-aligned sizes; int4: whole scale groups and N / t
    a multiple of 8)."""
    if numel < min_size or any(n % size for n in segments):
        return False
    parts = [n // size for n in segments]
    if layer.is_int4:
        if kind == 'row':
            return all(n % layer.group_size == 0 for n in parts)
        return all(n % 8 == 0 for n in parts)
    if layer.is_int8:
        return all(n % 8 == 0 for n in parts)
    return True


def set_tensor_parallel(module, tp, min_size: int = 2 ** 16) -> int:
    """Split ``module``'s blocks over ``tp`` (a ``LocalTensor`` or a
    ``TensorGroup``), in place; a training composition (not an
    ``nn.Module``) splits the denoisers its loss runs (``fsdp_modules``), a
    module they share (the tied teacher's trunk) once. Each unit that
    declares a plan (``tensor_plan``: the attention of a joint block, a
    single block, an MLP, an AdaLN modulation) is split when all its
    layers can be (``_layer_ok``, with JAX's ``min_size``) and its heads
    divide; else it stays whole and runs replicated. Under a
    ``TensorGroup`` a split layer keeps only its part. Call it after
    quantizing and before sharding over ``fsdp``. MoE blocks raise
    (item 5.13). ``tp`` None (or of size 1) makes a ``LocalTensor`` split
    whole again. Returns the number of split units."""
    roots = [module] if isinstance(module, nn.Module) \
        else list(module.fsdp_modules().values())
    if tp is None or tp.size == 1:
        for root in roots:
            _unsplit(root)
        return 0
    seen, n_units = set(), 0
    for root in roots:
        for path, m in root.named_modules():
            if id(m) in seen or not hasattr(m, 'tensor_plan'):
                continue
            seen.add(id(m))
            plan, heads = m.tensor_plan()
            ok = tp is not None and tp.size > 1 and heads % tp.size == 0
            for name, (kind, segments) in plan.items():
                layer = m.get_submodule(name)
                numel = layer.in_features * layer.out_features * _stack_len(
                    root, f'{path}.{name}' if path else name)
                ok = ok and _layer_ok(layer, kind, segments, tp.size, numel,
                                      min_size)
            m.tensor_parallel = tp if ok else None
            if ok:
                n_units += 1
                for name, (kind, segments) in plan.items():
                    m.get_submodule(name).split_tensor(tp, kind, segments)
    return n_units


def _unsplit(module: nn.Module) -> None:
    """Every unit of ``module`` whole again; a ``LocalTensor`` split kept
    the whole tensors, a ``TensorGroup`` one did not and raises."""
    for m in module.modules():
        if getattr(m, 'tensor_split', None) is not None:
            if m.tensor_parallel.holds_parts:
                raise ValueError('a rank of a tensor group holds only its '
                                 'parts: its split cannot be undone')
            m.tensor_split, m._tensor_parts = None, {}
        if hasattr(m, 'tensor_parallel'):
            m.tensor_parallel = None


def tensor_splits(module: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...],
                                                        Optional[int]]]:
    """{tensor name: (kind, segments, group size)} of every split tensor of
    ``module`` (names as in its ``state_dict``)."""
    from ..models.layers import LoRADense
    out = {}
    for path, m in module.named_modules():
        if isinstance(m, LoRADense) and m.tensor_split is not None:
            kind, segments = m.tensor_split
            for name in m.split_names():
                out[f'{path}.{name}' if path else name] = (
                    kind, segments, m.group_size)
    return out


class TensorPlacement:
    """A training model split over the ``tensor`` axis of a ('data',
    'fsdp', 'tensor') mesh, and what a train step and a checkpoint need of
    it, in ``parallel/model_parallel.py:ModelParallel``'s interface: the
    one-device layout of a tensor (``gather_full``), this rank's part of
    one (``local_part``, before FSDP2's ``shard_of``) and which tensors
    this rank counts in the global norm (``counted``, summed over
    ``model_group``: the fsdp x tensor ranks of this data coordinate)."""

    fsdp = True         # FSDP2 reduces the gradients over data x fsdp

    def __init__(self, mesh, tp: TensorGroup, splits: Dict,
                 shapes: Dict[str, Tuple[int, ...]]):
        self.mesh, self.tp, self.splits, self.shapes = mesh, tp, splits, shapes
        names = mesh.mesh_dim_names
        grid = mesh.mesh
        d = names.index('data')
        rows = grid.movedim(d, 0).reshape(grid.shape[d], -1)
        from .model_parallel import _new_groups
        self.model_group = _new_groups(rows) if rows.shape[1] > 1 else None

    def counted(self, name: str) -> bool:
        return name in self.splits or self.tp.rank == 0

    def reduce_gradients(self, params) -> None:
        """Nothing: FSDP2 averages over data x fsdp, and a tensor group's
        gradients need no reduction (module docstring)."""

    def gather_full(self, name: str, t: torch.Tensor
                    ) -> Optional[torch.Tensor]:
        """The one-device tensor ``name`` on rank 0 (None elsewhere); every
        rank calls it for the same names in the same order."""
        from .fsdp import is_sharded
        if is_sharded(t):
            t = t.full_tensor()
        split = self.splits.get(name)
        if split is not None:
            kind, segments, gs = split
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.tp.size)]
            dist.all_gather(parts, t, group=self.tp.group)
            t = join_parts(parts, name.rsplit('.', 1)[-1], kind, segments,
                           gs)
        return t if dist.get_rank() == 0 else None

    def local_part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        split = self.splits.get(name)
        if split is None:
            return full
        kind, segments, gs = split
        return split_part(full, name.rsplit('.', 1)[-1], kind, segments,
                          self.tp.size, self.tp.rank, gs)


def partition_tensor(model, mesh, min_size: int = 2 ** 16
                     ) -> TensorPlacement:
    """Split ``model`` (a composition) over ``mesh``'s ``tensor`` axis
    (``set_tensor_parallel`` with the mesh's tensor group), before FSDP2
    shards it over ``fsdp``; sets and returns ``model.model_parallel``."""
    tp = TensorGroup(mesh.get_group('tensor'))
    roots = [model] if isinstance(model, nn.Module) \
        else list(model.fsdp_modules().values())
    shapes = {}
    for root in roots:
        for name, t in (*root.named_parameters(), *root.named_buffers()):
            shapes.setdefault(name, tuple(t.shape))
    set_tensor_parallel(model, tp, min_size)
    splits = {}
    for root in roots:
        splits.update(tensor_splits(root))
    model.model_parallel = TensorPlacement(mesh, tp, splits, shapes)
    return model.model_parallel


def check_ulysses_heads(num_heads: int, tensor: int, sp: int) -> None:
    """Ulysses under ``tensor`` trades token shards for shards of the
    H / t heads a rank holds: (H / t) % sp must be 0."""
    if (num_heads // tensor) % sp:
        raise ValueError(f'Ulysses under tensor={tensor} needs (heads / '
                         f'tensor) % sp == 0, got {num_heads} heads / '
                         f'{tensor} over sp={sp}: use sp_mode="ring"')

