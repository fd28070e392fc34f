"""Process groups, the device mesh and the sequence-parallel (``sp``) state.

Counterpart of ``arcflow_tpu/parallel/mesh.py``: ``setup_distributed``
(its lines 31-58) starts the process group; ``make_mesh`` (61-110) lays
the ranks out on the ``data``, ``fsdp`` and ``sp`` axes as a 2-D or 3-D
``DeviceMesh`` (the JAX mesh's axes, sizes and device order, ``-1`` and
``dcn_axes`` included) or takes the ``sp`` axis alone for serving;
``batch_axes`` / ``batch_ranks`` (165-172) say over which ranks the batch
is split and where this rank's rows lie (all ranks of one ``sp`` group
hold the same rows); ``batch_draw`` draws a step's per-sample randomness
for the global batch and keeps this rank's rows, as GSPMD splits JAX's
one-key draw, and ``global_rows`` numbers this rank's rows in the global
batch. One explicit ``SequenceParallel`` object, held by the
transformer's attention modules and its trunk, replaces the
process-global activation state ``_ACT`` (245-306; ``sp_mode`` picks its
layout). Its helpers cut the tokens into this rank's shard and gather them
back (JAX ``shard_activation('residual')``), and move attention between
token shards and head shards for the Ulysses layout (JAX
``heads_partition``, 379-405); under autograd each one's backward is its
inverse collective (the gather's a reduce-scatter). The ``pipe`` and
``expert`` axes are dimensions of the training mesh beside ``data`` /
``fsdp``; their placement rules (``param_spec_for_path`` 183-207,
``stacked_param_spec`` 320-343, ``moe_param_spec`` 346-372) are ported
here on JAX-layout shapes, and ``parallel/model_parallel.py`` places the
port's modules by them. The ``tensor`` axis is a dimension of the training
mesh beside ``data`` / ``fsdp``, or in serving an axis alone or beside
``sp``; ``parallel/tensor.py`` splits the blocks over it.
"""

from __future__ import annotations

import contextlib
import math
import os
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

SP_MODES = ('ring', 'ulysses')
# the axes the batch is split over, in the DeviceMesh's dimension order:
# replicated over data, sharded over fsdp (HSDP)
TRAIN_AXES = ('data', 'fsdp')
# the model-parallel axes: the ranks along them hold the same rows
MODEL_AXES = ('pipe', 'expert')
# a training mesh's dimensions, in this order; pipe, expert, sp and tensor
# are dimensions of it only where their size is above 1
MESH_AXES = TRAIN_AXES + MODEL_AXES + ('sp', 'tensor')
# the axes whose serving mesh is {axis: process group}, alone or together
SERVING_AXES = ('sp', 'tensor')
# compositions of axes that wait, with their ROADMAP.md queue A item
SP_WITH_MODEL_AXES = '5.8'
FSDP_WITH_MODEL_AXES = '5.10'
TENSOR_WITH_SP_TRAINING = '5.11'
TENSOR_WITH_MODEL_AXES = '5.12'


def setup_distributed(device: Optional[str] = None, timeout: float = 600.0
                      ) -> torch.device:
    """Start the default process group from ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK`` (the variables
    ``parallel/launch.py:spawn`` and ``torch.distributed.run`` set) and
    return this rank's device: NCCL on ``cuda:{LOCAL_RANK}``, or gloo on
    the CPU when ``device='cpu'``. Without ``WORLD_SIZE`` it starts a
    group of this one process on an in-memory store (a mesh of one device
    needs a group too). Without a CUDA device and without ``device='cpu'``
    it raises. ``timeout`` (seconds) bounds every collective."""
    if 'WORLD_SIZE' in os.environ:
        rank = int(os.environ['RANK'])
        world = int(os.environ['WORLD_SIZE'])
        init = dict(init_method='env://')
    else:
        rank, world = 0, 1
        init = dict(store=dist.HashStore())
    if device == 'cpu':
        backend, dev = 'gloo', torch.device('cpu')
    elif device is None or device == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" to run the '
                               'ranks on the CPU over gloo')
        backend = 'nccl'
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', rank)))
        torch.cuda.set_device(dev)
    else:
        raise ValueError(f'device must be "cuda" or "cpu", got {device!r}')
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout), **init)
    return dev


def mesh_shape(axes: Dict[str, int], n_devices: int,
               dcn_axes: Optional[Dict[str, int]] = None
               ) -> Dict[str, int]:
    """The axis sizes JAX's ``make_mesh`` gives ``axes`` on ``n_devices``
    (its lines 78-107): one ``-1`` takes ``n_devices`` over the product of
    the other sizes and of the ``dcn_axes`` sizes (floor division, as
    JAX: a mesh that does not divide comes out with a wrong product and
    is refused); an axis named in ``dcn_axes`` has size dcn x ici. A
    product other than ``n_devices`` raises ``ValueError`` with JAX's
    message."""
    names = list(axes)
    sizes = [int(v) for v in axes.values()]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if dcn_axes:
            known *= math.prod(dcn_axes.values())
        sizes[sizes.index(-1)] = n_devices // known
    if dcn_axes:
        ici = tuple(sizes)
        dcn = tuple(int(dcn_axes.get(n, 1)) for n in names)
        if math.prod(ici) * math.prod(dcn) != n_devices:
            raise ValueError(f'ici {ici} x dcn {dcn} != {n_devices} devices')
        sizes = [d * i for d, i in zip(dcn, ici)]
    elif math.prod(sizes) != n_devices:
        raise ValueError(f'mesh {dict(zip(names, sizes))} != {n_devices} '
                         f'devices')
    return dict(zip(names, sizes))


def make_mesh(axes: Dict[str, int],
              dcn_axes: Optional[Dict[str, int]] = None,
              serving: bool = False):
    """The ranks laid out on ``axes``.

    * ``{'data': d, 'fsdp': f}`` (either may be left out, one may be -1,
      ``dcn_axes`` as in JAX) -> a 2-D ``DeviceMesh`` with dimensions
      ('data', 'fsdp') over every process of the default group (start it
      with ``setup_distributed``; NCCL gives a mesh on the card, gloo one
      on the CPU). Rank r sits where JAX puts device r: the ranks in
      order, reshaped to the sizes in the order ``axes`` names them, with
      a dcn factor outermost within its axis. A product of sizes other
      than the world size raises as JAX's does (``mesh_shape``).
    * the same with ``'sp': n`` above 1 beside them (training under
      ``sp``) -> a 3-D ``DeviceMesh`` ('data', 'fsdp', 'sp'): the ranks of
      one sp group hold the same rows and share their sequence; its group
      is ``mesh.get_group('sp')``.
    * ``{'sp': n}`` alone -> {'sp': the process group of the n ranks},
      as before: the axis must span every process (-1 takes them all); a
      one-process ``sp`` of 1 has no group.

    * ``'pipe'`` and ``'expert'`` beside ``data`` / ``fsdp`` -> a
      ``DeviceMesh`` of up to 4 dimensions ('data', 'fsdp', 'pipe',
      'expert'), the ranks in JAX's device order as above: the ranks along
      ``pipe`` and ``expert`` hold the same rows (``batch_axes``); the
      stages and experts they hold are ``parallel/model_parallel.py``'s.
    * ``'tensor': t`` beside ``data`` / ``fsdp`` -> a 3-D ``DeviceMesh``
      ('data', 'fsdp', 'tensor') in JAX's device order: the ranks of one
      tensor group hold the same rows and split the blocks
      (``parallel/tensor.py``).
    * ``{'tensor': t}`` or ``{'sp': s, 'tensor': t}`` (serving) -> {axis:
      this rank's process group along it (None for size 1)}, the ranks in
      JAX's device order over the sizes in the order given.
    * ``serving=True`` (``ArcFluxPipeline.shard``): the same, and a mesh
      with ``data``, ``fsdp``, ``pipe`` or ``expert`` is the
      ``DeviceMesh`` of the training grid ('data', 'fsdp', then those of
      'pipe', 'expert', 'sp', 'tensor' above size 1), in JAX's device
      order, ``sp`` and ``tensor`` beside ``data`` / ``fsdp`` included.

    ``sp`` beside ``pipe`` or ``expert`` raises ``NotImplementedError``
    naming its ROADMAP.md item (5.8), as do ``tensor`` beside ``sp`` in a
    training mesh (5.11), ``tensor`` beside ``pipe`` or ``expert`` (5.12)
    and, in serving, ``fsdp`` above 1 beside ``pipe`` or ``expert`` (5.10,
    which ``parallel/model_parallel.py`` refuses in training)."""
    model_axes = sorted(set(axes) & set(MODEL_AXES))
    if 'sp' in axes and model_axes:
        raise NotImplementedError(
            f'mesh axes {model_axes} beside \'sp\' are not ported yet '
            f'(ROADMAP.md queue A item {SP_WITH_MODEL_AXES}): the port '
            f'trains and serves sp beside data and fsdp only')
    if 'tensor' in axes and model_axes:
        raise NotImplementedError(
            f'mesh axes {model_axes} beside \'tensor\' are not ported yet '
            f'(ROADMAP.md queue A item {TENSOR_WITH_MODEL_AXES})')
    if serving and model_axes and int(axes.get('fsdp', 1)) > 1:
        raise NotImplementedError(
            f'fsdp > 1 beside {model_axes} is not ported yet (ROADMAP.md '
            f'queue A item {FSDP_WITH_MODEL_AXES}): set fsdp to 1, or leave '
            f'pipe and expert out')
    if {'sp', 'tensor'} <= set(axes) and set(axes) - set(SERVING_AXES) \
            and not serving:
        raise NotImplementedError(
            f'mesh axes [\'sp\', \'tensor\'] together in a training mesh '
            f'are not ported yet (ROADMAP.md queue A item '
            f'{TENSOR_WITH_SP_TRAINING}): training takes tensor beside data '
            f'and fsdp, serving takes sp x tensor')
    unknown = sorted(set(axes) - set(MESH_AXES))
    if unknown:
        raise ValueError(f'unknown mesh axes {unknown}')
    world = dist.get_world_size() if dist.is_initialized() else 1
    if 'tensor' in axes and set(axes) <= set(SERVING_AXES):
        return serving_mesh(axes, world)
    if set(axes) <= {'sp'}:
        n = axes.get('sp', 1)
        n = world if n == -1 else n
        if n != world:
            raise ValueError(f'sp={n} must span every process ({world}); '
                             f'start them with setup_distributed')
        return {'sp': dist.group.WORLD if dist.is_initialized() else None}
    sizes = mesh_shape(axes, world, dcn_axes)
    for a in MESH_AXES[2:]:
        if sizes.get(a, 1) == 1:
            sizes.pop(a, None)
    if not dist.is_initialized():
        raise RuntimeError('a data/fsdp mesh needs a process group: start '
                           'it with setup_distributed (one process too)')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(device_type, mesh_ranks(sizes),
                      mesh_dim_names=mesh_axes(sizes))


class ServingRows:
    """The rows of a served batch that this rank runs, over the (data,
    fsdp) grid of a serving ``DeviceMesh`` (JAX ``batch_axes``: the ranks
    along ``sp``, ``tensor``, ``pipe`` and ``expert`` hold the same rows),
    and their gather back. A batch of B rows that the grid's n ranks
    divide is cut into n blocks of B / n, block i on batch rank i
    (``batch_ranks``); a batch they do not divide (batch 1 on ``fsdp=4``)
    runs whole on every rank, whose gathered weights (FSDP2) and inputs
    are the same, so every rank computes the same rows. Either way every
    rank returns the whole batch."""

    def __init__(self, mesh):
        from .model_parallel import _new_groups
        grid = mesh.mesh
        rows = grid.reshape(grid.shape[0] * grid.shape[1], -1).t()
        self.index, self.count = batch_ranks(mesh)
        self.group = _new_groups(rows) if self.count > 1 else None
        me = dist.get_rank()
        mine = next(r for r in rows.tolist() if me in r)
        # the group rank (its ranks in ascending order) of each row block
        self.order = [sorted(mine).index(r) for r in mine]

    def splits(self, batch: int) -> bool:
        """Whether a batch of ``batch`` rows is cut over the ranks."""
        return self.count > 1 and batch % self.count == 0

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``'s rows."""
        b = x.shape[0] // self.count
        return x.narrow(0, self.index * b, b)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch from every rank's block ``x``, in row order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.count)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat([parts[i] for i in self.order])


def serving_mesh(axes: Dict[str, int], world: int) -> Dict[str, object]:
    """``make_mesh``'s serving form with ``tensor``: {axis: this rank's
    group along it, None for an axis of size 1}. Rank r sits where JAX
    puts device r: the ranks reshaped to the sizes in the order ``axes``
    names them, so at ``{'sp': s, 'tensor': t}`` a tensor group is t
    consecutive ranks."""
    sizes = mesh_shape(axes, world)
    if world == 1:
        return {a: None for a in sizes}
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    dm = DeviceMesh(device_type,
                    torch.arange(world).reshape(tuple(sizes.values())),
                    mesh_dim_names=tuple(sizes))
    return {a: dm.get_group(a) if n > 1 else None for a, n in sizes.items()}


def mesh_axes(sizes) -> Tuple[str, ...]:
    """The dimensions of the training mesh of ``sizes``: ('data', 'fsdp'),
    then those of 'pipe', 'expert', 'sp' and 'tensor' that are axes of
    them, in that order."""
    return TRAIN_AXES + tuple(a for a in MESH_AXES[2:] if a in sizes)


def mesh_ranks(sizes: Dict[str, int]) -> torch.Tensor:
    """The ranks on the ``mesh_axes`` grid for ``mesh_shape``'s ``sizes``:
    0 .. n-1 reshaped to the sizes in their given order, as JAX places its
    devices, then ordered as ``mesh_axes``; an axis left out has size
    1."""
    dims = mesh_axes(sizes)
    ranks = torch.arange(math.prod(sizes.values())).reshape(
        tuple(sizes.values()))
    ranks = ranks.permute([list(sizes).index(a) for a in dims
                           if a in sizes])
    return ranks.reshape(tuple(sizes.get(a, 1) for a in dims))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch is split over: ``data`` and ``fsdp`` (JAX
    ``batch_axes``: FSDP ranks hold different parameter shards and see
    different rows too); the ranks along ``pipe``, ``expert``, ``sp`` and
    ``tensor`` hold the same rows."""
    return tuple(a for a in TRAIN_AXES if a in mesh.mesh_dim_names)


def batch_order(mesh) -> Sequence[int]:
    """The ranks in the order of the rows they hold: the (data, fsdp)
    grid read row by row, as JAX lays out ``P(('data', 'fsdp'))``; of each
    group along ``pipe``, ``expert``, ``sp`` and ``tensor`` (which holds
    the same rows) its first rank."""
    grid = mesh.mesh
    return grid.reshape(grid.shape[0], grid.shape[1], -1)[..., 0] \
        .flatten().tolist()


def batch_ranks(mesh) -> Tuple[int, int]:
    """(this rank's index among the batch ranks, their count): its rows
    of a global batch of n x b are [index x b, (index + 1) x b). Every
    rank of a group along ``pipe``, ``expert``, ``sp`` or ``tensor`` has
    its group's index."""
    order = batch_order(mesh)
    d, f = mesh.get_coordinate()[:2]
    return order.index(int(mesh.mesh[d, f].flatten()[0])), len(order)


# This process's (index, count) in the global batch while a sharded step
# runs (``batch_rows``): read by the per-sample draws of the loss
# (``batch_draw``) and by the LoRA dropout's per-row generators
# (``global_rows``), so the model's and the diffusion's signatures stay the
# JAX package's.
_BATCH_ROWS = (0, 1)


@contextlib.contextmanager
def batch_rows(index: int, count: int):
    """Within the block, ``batch_draw`` draws for a global batch of
    ``count`` x the local rows and keeps block ``index`` of them, and
    ``global_rows`` numbers the local rows so."""
    global _BATCH_ROWS
    prev, _BATCH_ROWS = _BATCH_ROWS, (index, count)
    try:
        yield
    finally:
        _BATCH_ROWS = prev


# While a pipeline stage runs a microbatch (``microbatch_rows``): its first
# row among this rank's rows, and this rank's row count.
_MICROBATCH = None


@contextlib.contextmanager
def microbatch_rows(offset: int, rows: int):
    """Within the block the forward runs the microbatch whose first row is
    row ``offset`` of this rank's ``rows``: ``global_rows`` numbers its
    rows so (``parallel/pipeline.py``), and a pipelined step draws the
    one-device step's dropout masks."""
    global _MICROBATCH
    prev, _MICROBATCH = _MICROBATCH, (offset, rows)
    try:
        yield
    finally:
        _MICROBATCH = prev


def batch_ranks_count() -> int:
    """The number of batch ranks of the sharded step running now (1
    outside one)."""
    return _BATCH_ROWS[1]


def global_rows(b: int) -> range:
    """The rows of the global batch that this rank's ``b`` rows are (a
    microbatch's within ``microbatch_rows``)."""
    index, _ = _BATCH_ROWS
    if _MICROBATCH is None:
        return range(index * b, (index + 1) * b)
    offset, rows = _MICROBATCH
    return range(index * rows + offset, index * rows + offset + b)


def batch_draw(fn, shape: Sequence[int], **kwargs) -> torch.Tensor:
    """``fn(shape, **kwargs)`` (``torch.rand`` or ``torch.randn``) for a
    draw with one row per sample: inside ``batch_rows(i, n)`` the draw of
    the whole batch (n x ``shape[0]`` rows) from the shared generator, of
    which block i is returned, so every rank advances its generator alike
    and a sample draws what it draws on one device."""
    index, count = _BATCH_ROWS
    if count == 1:
        return fn(tuple(shape), **kwargs)
    b = shape[0]
    return fn((b * count, *shape[1:]), **kwargs).narrow(0, index * b, b)


class SequenceParallel:
    """This rank's place in a sequence-parallel group and the layout of
    attention over it (``mode``): 'ring' keeps the sequence cut inside
    attention and rotates K/V blocks (``parallel/ring_attention.py``);
    'ulysses' trades the token shard for a head shard of the full sequence
    with one all-to-all on each side of the attention kernel."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None,
                 mode: str = 'ulysses'):
        if mode not in SP_MODES:
            raise ValueError(f'sp_mode must be one of {SP_MODES}, got '
                             f'{mode!r}')
        self.group = group or dist.group.WORLD
        self.mode = mode
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's contiguous slice of ``x`` along ``dim``."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f'{n} tokens do not split over {self.size} '
                             f'ranks')
        return x.narrow(dim, self.rank * (n // self.size), n // self.size)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order.
        Differentiable: the backward sums every rank's gradient of the
        whole and gives each rank its slice (a reduce-scatter), so a rank's
        shard gets the gradient of all ranks' uses of the gathered tensor
        (``parallel/fsdp.py`` states what that makes of the parameter
        gradients)."""
        if x.dtype == torch.bool:
            return self.gather(x.to(torch.uint8), dim).bool()
        return _Gather.apply(x, self, dim)

    def seq_to_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S/n, H, D) token shard -> (B, S, H/n, D) head shard, the
        tokens in rank order (one all-to-all; differentiable, the backward
        is ``heads_to_seq``)."""
        if x.shape[2] % self.size:
            raise ValueError(f'Ulysses needs heads % sp == 0, got '
                             f'{x.shape[2]} heads over {self.size} ranks: '
                             f'use sp_mode="ring"')
        return _SeqToHeads.apply(x, self)

    def heads_to_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of ``seq_to_heads``: (B, S, H/n, D) -> (B, S/n, H,
        D) (differentiable, the backward is ``seq_to_heads``)."""
        return _HeadsToSeq.apply(x, self)

    def _all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def _reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the ranks of ``x``, this rank's slice along
        ``dim``."""
        parts = x.chunk(self.size, dim=dim)
        recv = torch.empty_like(parts[0], memory_format=torch.contiguous_format)
        dist.reduce_scatter_tensor(recv, torch.cat(parts, dim=0),
                                   group=self.group)
        return recv

    def _seq_to_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h, d = x.shape
        n = self.size
        send = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
        recv = torch.empty_like(send, memory_format=torch.contiguous_format)
        dist.all_to_all_single(recv, send.contiguous(), group=self.group)
        return recv.transpose(0, 1).reshape(b, n * s, h // n, d)

    def _heads_to_seq(self, x: torch.Tensor) -> torch.Tensor:
        b, s_all, hn, d = x.shape
        n = self.size
        send = x.reshape(b, n, s_all // n, hn, d).transpose(0, 1)
        recv = torch.empty_like(send, memory_format=torch.contiguous_format)
        dist.all_to_all_single(recv, send.contiguous(), group=self.group)
        return recv.permute(1, 2, 0, 3, 4).reshape(b, s_all // n, n * hn, d)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, dim):
        ctx.sp, ctx.dim = sp, dim
        return sp._all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.sp._reduce_scatter(grad, ctx.dim), None, None


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return sp._seq_to_heads(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.sp._heads_to_seq(grad), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return sp._heads_to_seq(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.sp._seq_to_heads(grad), None


def stream_padding(sp, *lengths: int):
    """The zero tokens to append to each stream of ``lengths`` tokens so
    that the sequence-parallel state ``sp`` (a ``SequenceParallel``, a
    ``LocalRing`` or None) cuts it into equal shards: 0 without ``sp`` or
    where ``sp.size`` divides the length. The JAX package leaves such a
    stream replicated instead (``arcflow_tpu/parallel/mesh.py:459-460``);
    padded keys are masked and padded rows dropped, so the result is the
    same."""
    size = 1 if sp is None else sp.size
    return [-n % size for n in lengths]


def pad_tokens(x: torch.Tensor, pad: int, dim: int = 1) -> torch.Tensor:
    """``x`` with ``pad`` zero tokens appended along ``dim``."""
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def token_validity(x: torch.Tensor, pad: int,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N + pad) bool validity of the tokens of ``x`` (B, N, ...):
    ``valid`` (every token when None), then ``pad`` invalid ones."""
    if valid is None:
        valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    return pad_tokens(valid.bool(), pad)


def token_streams(sp, n_txt: int, n_img: int, device=None):
    """Where the tokens a trunk holds under ``sp`` sit in the single-device
    streams of ``n_txt`` text and ``n_img`` image tokens: {'txt': (index,
    n_txt), 'img': (index, n_img), 'joint': (index, n_txt + n_img)} for
    the text stream, the image stream and their [txt, img] concatenation
    (``models/layers.py:DropoutRows``; a padded token takes the last
    real one's place, its rows are dropped). None where the trunk holds the
    streams as one device does: without ``sp``, or on a ``LocalRing`` that
    pads nothing."""
    pad_t, pad_i = stream_padding(sp, n_txt, n_img)
    if sp is None or (not isinstance(sp, SequenceParallel)
                      and not (pad_t or pad_i)):
        return None
    txt = torch.arange(n_txt + pad_t, device=device).clamp_(
        max=max(n_txt - 1, 0))
    img = torch.arange(n_img + pad_i, device=device).clamp_(
        max=max(n_img - 1, 0))
    if isinstance(sp, SequenceParallel):
        txt, img = sp.shard(txt, dim=0), sp.shard(img, dim=0)
    return dict(txt=(txt, n_txt), img=(img, n_img),
                joint=(torch.cat([txt, img + n_txt]), n_txt + n_img))


def set_sequence_parallel(module, sp) -> None:
    """Give ``module`` and each of its submodules that holds sequence-
    parallel state (the trunks and their attention modules) ``sp``: a
    ``SequenceParallel``, a ``LocalRing`` or None (one device). A training
    composition (not an ``nn.Module``) passes it to the denoisers its loss
    runs (``fsdp_modules``: the student and the teacher)."""
    roots = [module] if isinstance(module, nn.Module) \
        else list(module.fsdp_modules().values())
    for root in roots:
        for m in root.modules():
            if hasattr(m, 'sequence_parallel'):
                m.sequence_parallel = sp


# ---- placement specs --------------------------------------------------------
# The port's copy of JAX's placement rules (``arcflow_tpu/parallel/mesh.py``:
# ``param_spec_for`` 131-150, ``param_spec_for_path`` 183-207,
# ``stacked_param_spec`` 320-343, ``moe_param_spec`` 346-372), on the shapes
# of JAX's layout (a block stack's leaves carry the layer dimension L first,
# an expert leaf (E, ...) or (L, E, ...)). A spec is a tuple of axis names or
# None per dimension, as JAX's ``PartitionSpec``; an empty tuple replicates.
# ``parallel/model_parallel.py`` places the port's modules by them.

Spec = Tuple[Optional[str], ...]


def _numel(shape) -> int:
    return math.prod(shape)


def param_spec_for(shape: Sequence[int], fsdp_axis: Optional[str],
                   fsdp_size: int, tensor_axis: Optional[str] = None,
                   tensor_size: int = 1, min_size: int = 2 ** 16) -> Spec:
    """JAX ``param_spec_for``: the last dim over ``tensor`` when it
    divides, the largest remaining dim over ``fsdp``."""
    shape = tuple(shape)
    if _numel(shape) < min_size or len(shape) == 0:
        return ()
    spec = [None] * len(shape)
    if (tensor_axis and tensor_size > 1 and len(shape) >= 2
            and shape[-1] % tensor_size == 0 and shape[-1] >= tensor_size):
        spec[-1] = tensor_axis
    if fsdp_axis and fsdp_size > 1:
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if spec[d] is None and shape[d] % fsdp_size == 0 \
                    and shape[d] >= fsdp_size:
                spec[d] = fsdp_axis
                break
    return tuple(spec)


def stacked_param_spec(shape: Sequence[int], pipe_axis: str, pipe_size: int,
                       fsdp_axis: Optional[str] = None, fsdp_size: int = 1,
                       tensor_axis: Optional[str] = None,
                       tensor_size: int = 1, min_size: int = 2 ** 16) -> Spec:
    """JAX ``stacked_param_spec``: a stacked block leaf (L, ...) puts its
    layer dim on ``pipe`` when the pipe degree divides L (each stage holds
    its own layers), the rest as ``param_spec_for`` would."""
    shape = tuple(shape)
    if len(shape) < 1 or shape[0] % pipe_size != 0:
        return param_spec_for(shape, fsdp_axis, fsdp_size, tensor_axis,
                              tensor_size, min_size)
    spec = [None] * len(shape)
    spec[0] = pipe_axis
    if _numel(shape) >= min_size:
        if (tensor_axis and tensor_size > 1 and len(shape) >= 2
                and shape[-1] % tensor_size == 0):
            spec[-1] = tensor_axis
        if fsdp_axis and fsdp_size > 1:
            for d in sorted(range(1, len(shape)), key=lambda d: -shape[d]):
                if spec[d] is None and shape[d] % fsdp_size == 0 \
                        and shape[d] >= fsdp_size:
                    spec[d] = fsdp_axis
                    break
    return tuple(spec)


def moe_param_spec(shape: Sequence[int], expert_axis: str, expert_size: int,
                   stacked: bool = False, pipe_axis: Optional[str] = None,
                   pipe_size: int = 1, fsdp_axis: Optional[str] = None,
                   fsdp_size: int = 1, tensor_axis: Optional[str] = None,
                   tensor_size: int = 1, min_size: int = 2 ** 16) -> Spec:
    """JAX ``moe_param_spec``: an MoE leaf (E, ...), or (L, E, ...) when
    ``stacked``, pins its expert dim to ``expert`` where it divides (each
    rank owns its experts), the layer dim to ``pipe``, the rest to the
    TP / FSDP rule."""
    shape = tuple(shape)
    if len(shape) < 1:
        return ()
    spec = [None] * len(shape)
    ed = 0
    if stacked:
        ed = 1
        if pipe_axis and pipe_size > 1 and shape[0] % pipe_size == 0:
            spec[0] = pipe_axis
    if expert_size > 1 and len(shape) > ed and shape[ed] % expert_size == 0:
        spec[ed] = expert_axis
    if _numel(shape) >= min_size:
        if (tensor_axis and tensor_size > 1 and len(shape) >= ed + 2
                and shape[-1] % tensor_size == 0):
            spec[-1] = tensor_axis
        if fsdp_axis and fsdp_size > 1:
            for d in sorted(range(ed + 1, len(shape)),
                            key=lambda d: -shape[d]):
                if spec[d] is None and shape[d] % fsdp_size == 0 \
                        and shape[d] >= fsdp_size:
                    spec[d] = fsdp_axis
                    break
    return tuple(spec)


def param_spec_for_path(path: str, shape: Sequence[int],
                        sizes: Dict[str, int],
                        fsdp_axis: Optional[str] = 'fsdp',
                        tensor_axis: Optional[str] = 'tensor',
                        pipe_axis: Optional[str] = 'pipe',
                        expert_axis: Optional[str] = 'expert',
                        stacked_markers: Sequence[str] = ('blocks',),
                        moe_markers: Sequence[str] = ('moe',),
                        min_size: int = 2 ** 16) -> Spec:
    """JAX ``param_spec_for_path`` for the leaf at ``path`` (JAX's
    '/'-joined param path) of JAX-layout ``shape`` on a mesh of axis
    ``sizes``: MoE leaves by ``moe_param_spec``, stacked block leaves by
    ``stacked_param_spec``, the rest by ``param_spec_for``."""
    def size(axis):
        return sizes.get(axis, 1) if axis else 1
    fsdp, tensor = size(fsdp_axis), size(tensor_axis)
    pipe, expert = size(pipe_axis), size(expert_axis)
    stacked = any(m in path for m in stacked_markers)
    if expert > 1 and any(m in path for m in moe_markers):
        return moe_param_spec(shape, expert_axis, expert, stacked=stacked,
                              pipe_axis=pipe_axis, pipe_size=pipe,
                              fsdp_axis=fsdp_axis, fsdp_size=fsdp,
                              tensor_axis=tensor_axis, tensor_size=tensor,
                              min_size=min_size)
    if pipe > 1 and stacked:
        return stacked_param_spec(shape, pipe_axis, pipe, fsdp_axis, fsdp,
                                  tensor_axis, tensor, min_size)
    return param_spec_for(shape, fsdp_axis, fsdp, tensor_axis, tensor,
                          min_size)
