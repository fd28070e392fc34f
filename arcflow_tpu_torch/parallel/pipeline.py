"""Pipeline parallelism over a ``pipe`` axis: the GPipe and circular
schedules.

Counterpart of ``arcflow_tpu/parallel/pipeline.py`` (``pipe_partition``
:52, ``_pick_microbatches`` :80, ``pipeline_scan`` :92). A stack of L
blocks (an ``nn.ModuleList``) runs as S stages: the batch splits into M
microbatches, and at step t stage s applies its layers to the microbatch
that stage s - 1 handed it at step t - 1 (stage 0 takes fresh ones), for
V x M + S - 1 steps. With ``interleave`` V > 1 (the circular schedule)
stage s holds the V strided chunks s, S + s, 2S + s, ... of L / (S V)
layers each, and a microbatch rings around the stages V times; the
handoff from the last stage to stage 0 lines up only when M == S, so V
degrades to 1 unless M == S and L % (S V) == 0, as in JAX. The bubble is
(S - 1) / (V M + S - 1) of the steps.

One schedule, two transports of the stage handoff:

* ``LocalPipe(S)``: every stage in this process, the handoff a hand-over
  of tensors (the counterpart of the JAX tests' simulated devices, and of
  ``LocalRing``); every block is here;
* ``PipeGroup(group)``: one stage per rank of the mesh's ``pipe`` group,
  the handoff a point-to-point send to the next rank and a receive from
  the previous one (``batch_isend_irecv``, every step, as JAX's
  ``ppermute`` moves every step); a rank holds only its stage's blocks
  (``parallel/model_parallel.py`` frees the others).

Differentiable: each (stage, microbatch, chunk) item keeps its graph from
a detached input, and the backward runs the steps in reverse, each stage
taking its output's cotangent from the next stage (or, for a finished
microbatch, from the pipeline's output) and handing its input's cotangent
back. The gradient convention, as JAX's ``shard_map`` with replicated
in- and out-specs has it:

* every rank of the pipe group gets the last stage's output (JAX
  all-gathers it and keeps the last stage's copy); every rank then runs
  the same loss on the same rows, so the output's cotangent is the same
  on every rank, and the last stage uses its own;
* the cotangents of the pipeline's inputs are summed over the group: the
  carry's comes from stage 0 alone, a per-sample input's (temb, the key
  mask, ControlNet residuals: they ride the microbatches) from every
  stage's own layers. Every rank thus gets the whole gradient of the
  inputs, and whatever runs before the pipeline (the embedders) gets the
  same gradient on every rank: replicated parameters stay equal.

A block parameter's gradient is thus its one-device gradient on the rank
that holds it. LoRA dropout numbers its rows by the microbatch's offset
(``parallel.mesh.microbatch_rows``), so a pipelined step draws the
one-device step's masks (JAX folds the layer index into the pipeline's
dropout key, which its scan splits, so its pipelined dropout differs from
its own scan; ``tests/test_torch_pipeline_parallel.py`` names it).
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from .mesh import microbatch_rows


class LocalPipe:
    """The one-process schedule of ``size`` stages, ``microbatches`` M
    (None: one per stage) and ``interleave`` V."""

    def __init__(self, size: int, microbatches: Optional[int] = None,
                 interleave: int = 1):
        if size < 1:
            raise ValueError(f'a pipeline needs at least one stage, got '
                             f'{size}')
        self.size = size
        self.microbatches = microbatches
        self.interleave = max(1, int(interleave or 1))

    def stages(self) -> Sequence[int]:
        return range(self.size)

    def forward_shift(self, outs: Dict[int, tuple], like) -> Dict[int, tuple]:
        """What each stage receives from the previous one."""
        return {s: outs.get((s - 1) % self.size) for s in self.stages()}

    def backward_shift(self, grads: Dict[int, tuple], like
                       ) -> Dict[int, tuple]:
        """What each stage receives from the next one."""
        return {s: grads.get((s + 1) % self.size) for s in self.stages()}

    def last_output(self, out: Optional[tuple], like) -> tuple:
        return out

    def sum_over_stages(self, tensors: List[torch.Tensor]) -> None:
        pass


class PipeGroup(LocalPipe):
    """This rank's stage of the ``pipe`` process group ``group``; the
    schedule as ``LocalPipe``'s. Its blocks are placed for the V of
    ``placed_interleave`` (``model_parallel.partition_model``): a call
    whose batch degrades V raises, as the blocks would have to move."""

    def __init__(self, group: dist.ProcessGroup,
                 microbatches: Optional[int] = None, interleave: int = 1):
        super().__init__(dist.get_world_size(group), microbatches,
                         interleave)
        self.group = group
        self.rank = dist.get_rank(group)
        self._next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(group, (self.rank - 1) % self.size)
        self._last = dist.get_global_rank(group, self.size - 1)
        self._ready = False

    def stages(self) -> Sequence[int]:
        return [self.rank]

    def _exchange(self, send: Optional[tuple], dst: int, src: int,
                  like) -> tuple:
        if not self._ready:
            # a group's first p2p call must involve all its ranks (NCCL)
            dist.all_reduce(torch.zeros(1, device=like[0].device),
                            group=self.group)
            self._ready = True
        send = [torch.zeros_like(x) for x in like] if send is None \
            else [x.detach().contiguous() for x in send]
        recv = [torch.empty_like(x) for x in like]
        reqs = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t, dst, self.group, tag=i)
             for i, t in enumerate(send)]
            + [dist.P2POp(dist.irecv, t, src, self.group, tag=i)
               for i, t in enumerate(recv)])
        for req in reqs:
            req.wait()
        return tuple(recv)

    def forward_shift(self, outs, like):
        return {self.rank: self._exchange(outs.get(self.rank), self._next,
                                          self._prev, like)}

    def backward_shift(self, grads, like):
        return {self.rank: self._exchange(grads.get(self.rank), self._prev,
                                          self._next, like)}

    def last_output(self, out, like):
        out = [torch.empty_like(x) for x in like] if out is None \
            else [x.contiguous() for x in out]
        for x in out:
            dist.broadcast(x, src=self._last, group=self.group)
        return tuple(out)

    def sum_over_stages(self, tensors):
        for t in tensors:
            dist.all_reduce(t, group=self.group)


def pick_microbatches(batch: int, stages: int,
                      requested: Optional[int]) -> int:
    """JAX ``_pick_microbatches``: the largest divisor of ``batch`` at
    most ``requested`` (default: the stage count)."""
    want = requested if requested is not None else stages
    m = max(1, min(want, batch))
    while batch % m != 0:
        m -= 1
    return m


def placed_interleave(n_layers: int, stages: int, interleave: int) -> int:
    """The V a stack of ``n_layers`` runs at when the batch allows it:
    ``interleave``, or 1 where L % (S V) != 0."""
    v = max(1, int(interleave or 1))
    return v if n_layers % (stages * v) == 0 else 1


def pipe_partition(pipe, n_layers: int, batch_size: Optional[int] = None
                   ) -> Optional[Tuple[int, int, int]]:
    """(S, M, V) when ``pipe`` (a ``LocalPipe`` / ``PipeGroup`` or None)
    pipelines a stack of ``n_layers`` on a batch of ``batch_size``: its
    size is above 1 and divides the depth (JAX ``pipe_partition``); None
    otherwise, and the stack runs plain. V degrades to 1 unless M == S
    and L % (S V) == 0 (JAX ``pipeline_scan``)."""
    if pipe is None or pipe.size <= 1 or n_layers % pipe.size != 0:
        return None
    if batch_size is not None and batch_size <= 0:
        return None
    s = pipe.size
    m = pick_microbatches(batch_size, s, pipe.microbatches) \
        if batch_size is not None else None
    v = placed_interleave(n_layers, s, pipe.interleave)
    if m is not None and m != s:
        v = 1
    return s, m, v


def layer_stage(index: int, n_layers: int, stages: int,
                interleave: int = 1) -> int:
    """The stage that holds layer ``index`` of a pipelined stack: chunk c
    of S V chunks goes to stage c mod S (V = 1: the contiguous L / S
    layers of stage s, as ``P('pipe')`` places JAX's layer dim)."""
    v = placed_interleave(n_layers, stages, interleave)
    return (index // (n_layers // (stages * v))) % stages


class _Run:
    """One pipelined call: the schedule's forward, with the graph of each
    item kept for ``backward``."""

    def __init__(self, layer_fn, n_layers, pipe, s, m, v, n_carry):
        self.layer_fn, self.n_layers, self.pipe = layer_fn, n_layers, pipe
        self.s, self.m, self.v, self.n_carry = s, m, v, n_carry
        self.items = {}

    def _chunk(self, stage, vv, j, carry, riders, bm, b):
        l_chunk = self.n_layers // (self.s * self.v)
        first = (vv * self.s + stage) * l_chunk
        mb = tuple(None if r is None else r.narrow(0, j * bm, bm)
                   for r in riders)
        with microbatch_rows(j * bm, b):
            for li in range(first, first + l_chunk):
                carry = tuple(self.layer_fn(li, carry, mb))
        return carry

    def forward(self, carry, riders, grad: bool):
        s, m, v = self.s, self.m, self.v
        b = carry[0].shape[0]
        bm = b // m
        self.like = tuple(x.narrow(0, 0, bm) for x in carry)
        self.full_like = carry
        if grad:
            riders = tuple(
                r.detach().requires_grad_() if r is not None
                and r.requires_grad else r for r in riders)
        self.riders = riders
        received: Dict[int, tuple] = {}
        finals: List[Optional[tuple]] = [None] * m
        total = v * m + s - 1
        for t in range(total):
            outs = {}
            for st in self.pipe.stages():
                g = t - st
                if not 0 <= g < v * m:
                    continue
                vv, j = divmod(g, m)
                if st == 0 and vv == 0:
                    inp = tuple(x.narrow(0, j * bm, bm) for x in carry)
                else:
                    inp = received[st]
                if grad:
                    inp = tuple(x.detach().requires_grad_() for x in inp)
                out = self._chunk(st, vv, j, inp, riders, bm, b)
                if grad:
                    self.items[(st, g)] = (inp, out)
                if st == s - 1 and vv == v - 1:
                    finals[j] = out
                else:
                    outs[st] = out
            if t < total - 1:
                received = self.pipe.forward_shift(outs, self.like)
        last = None
        if finals[0] is not None:
            last = tuple(torch.cat([f[k] for f in finals])
                         for k in range(self.n_carry))
        return self.pipe.last_output(
            None if last is None else tuple(x.detach() for x in last),
            self.full_like)

    def backward(self, grads):
        s, m, v = self.s, self.m, self.v
        bm = self.like[0].shape[0]
        carry_grads: List[Optional[tuple]] = [None] * m
        received: Dict[int, tuple] = {}
        for t in reversed(range(v * m + s - 1)):
            sends = {}
            for st in self.pipe.stages():
                g = t - st
                if not 0 <= g < v * m:
                    continue
                vv, j = divmod(g, m)
                inp, out = self.items.pop((st, g))
                if st == s - 1 and vv == v - 1:
                    # an output the loss does not read has no cotangent
                    gout = tuple(None if gr is None
                                 else gr.narrow(0, j * bm, bm).to(o.dtype)
                                 for o, gr in zip(out, grads))
                else:
                    gout = received[st]
                pairs = [(o, go) for o, go in zip(out, gout)
                         if o.requires_grad and go is not None]
                if pairs:
                    torch.autograd.backward([p[0] for p in pairs],
                                            [p[1] for p in pairs])
                gin = tuple(torch.zeros_like(x) if x.grad is None else x.grad
                            for x in inp)
                if st == 0 and vv == 0:
                    carry_grads[j] = gin
                else:
                    sends[st] = gin
            if t > 0:
                received = self.pipe.backward_shift(sends, self.like)
        out = [torch.cat([carry_grads[j][k] if carry_grads[j] is not None
                          else torch.zeros_like(self.like[k])
                          for j in range(m)])
               for k in range(self.n_carry)]
        rider_grads = [None if r is None or not r.requires_grad
                       else (torch.zeros_like(r) if r.grad is None
                             else r.grad)
                       for r in self.riders]
        self.pipe.sum_over_stages(
            out + [g for g in rider_grads if g is not None])
        return out + rider_grads


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, n_carry, _anchor, *tensors):
        ctx.run = run
        ctx.set_materialize_grads(False)
        with torch.enable_grad():
            return run.forward(tensors[:n_carry], tensors[n_carry:],
                               grad=True)

    @staticmethod
    def backward(ctx, *grads):
        run, ctx.run = ctx.run, None
        return (None, None, None, *run.backward(grads))


def pipeline_run(layer_fn: Callable[[int, tuple, tuple], Sequence],
                 n_layers: int, carry: Sequence[torch.Tensor],
                 riders: Sequence[Optional[torch.Tensor]], pipe,
                 params: Iterable[torch.Tensor] = ()) -> Tuple:
    """Run layers 0 .. ``n_layers`` - 1 of a stack over ``carry`` (a tuple
    of (B, ...) tensors, shapes kept by every layer) as ``pipe``'s
    pipeline: ``layer_fn(i, carry, riders)`` applies layer i to a
    microbatch's carry with that microbatch's rows of ``riders`` (the
    per-sample inputs, (B, ...) or None; what every sample shares, as the
    rope tables, the caller closes over) and returns its new carry.
    ``params`` (the stack's parameters) say whether a backward is wanted.
    The drop-in schedule for ``for i in range(L): carry = layer_fn(i,
    carry, riders)``; returns the carry after the L layers."""
    carry, riders = tuple(carry), tuple(riders)
    s, m, v = pipe_partition(pipe, n_layers, carry[0].shape[0])
    placed = placed_interleave(n_layers, s, pipe.interleave)
    if isinstance(pipe, PipeGroup) and placed != v:
        raise NotImplementedError(
            f'this stack\'s blocks are placed for pipe_interleave {placed}, '
            f'but a batch of {carry[0].shape[0]} runs {m} microbatches over '
            f'{s} stages, which takes interleave {v} (the circular schedule '
            f'needs M == S): set pipe_microbatches to {s} and a batch it '
            f'divides')
    run = _Run(layer_fn, n_layers, pipe, s, m, v, len(carry))
    grad = torch.is_grad_enabled() and (
        any(x.requires_grad for x in carry + riders if x is not None)
        or any(p.requires_grad for p in params))
    if not grad:
        return run.forward(carry, riders, grad=False)
    anchor = torch.zeros((), requires_grad=True)
    return _Pipeline.apply(run, len(carry), anchor, *carry, *riders)


def set_pipe(module, pipe) -> None:
    """Give ``module`` and each of its submodules that runs block stacks
    (the FLUX and Qwen trunks) the pipe state ``pipe``: a ``LocalPipe``, a
    ``PipeGroup`` or None (the plain loop). A training composition (not an
    ``nn.Module``) passes it to the denoisers its loss runs."""
    roots = [module] if isinstance(module, torch.nn.Module) \
        else list(module.fsdp_modules().values())
    for root in roots:
        for m in root.modules():
            if hasattr(m, 'pipe'):
                m.pipe = pipe
