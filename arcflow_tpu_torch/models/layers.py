"""Shared DiT building blocks as ``nn.Module``s.

Counterpart of ``arcflow_tpu/models/layers.py``. Module and parameter names
follow the JAX param tree (``img_q``, ``img_q_norm``, ``modulation``, ...),
so ``pipelines/convert.py:jax_params_to_torch`` maps weights mechanically.

Dtypes: ``dtype`` is the dtype a module's parameters are made in and the
compute dtype of its matmuls, fixed at construction, as the JAX ``dtype``;
a parameter may later be cast to another storage dtype (the training
composition keeps the adapter in fp32 and may store the frozen trunk in
bf16, the JAX ``param_dtype``) and the layer still computes in ``dtype``.
Norm scales and LoRA leaves are made in fp32, as in the JAX package;
RMSNorm, LayerNorm and RoPE compute in fp32 and cast back.

Randomness: the LoRA branch's dropout draws from a ``torch.Generator``
passed down the ``forward`` calls (``generator=``), and only when one is
passed, as the JAX layers draw only under a ``dropout`` rng.

Initialisation follows the flax defaults of the JAX modules: a ``LoRADense``
kernel is truncated LeCun normal (fan-in = ``in_features``) and its bias
zero (``lecun_normal_``); the AdaLN modulations are zero (``_zero_dense``).

``LoRADense`` has the float path, the int8 path (weight-only or w8a8,
after ``utils/quantize.py:quantize_weights_int8``) and the int4 path
(weight-only or w4a8, after ``quantize_weights_int4``). The attention
modules hold their sequence-parallel state (``sequence_parallel``: None, a
``parallel.SequenceParallel`` in ring or Ulysses mode, or a
``parallel.LocalRing``), set by ``parallel.set_sequence_parallel``; the
MoE FFN (``MoEFeedForward``) holds its expert-parallel state
(``expert_parallel``, ``parallel/expert.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops
from ..ops import int8_matmul as i8_ops
from ..ops import quant_matmul as qmm_ops
from ..parallel import tensor as tensor_par
from ..parallel.ring_attention import LocalRing, ring_attention
from ..utils.quantize import unpack_nibbles


def timestep_sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep features [cos, sin], diffusers-compatible
    ordering, max period 10000."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's default kernel init in place: normal with variance 1 / fan-in,
    truncated at two standard deviations (the std corrected for the cut),
    fan-in = every axis but the output one (``in`` x kh x kw for a conv)."""
    std = 1.0 / math.sqrt(weight[0].numel()) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def _act_int8(x: torch.Tensor, absmax: Optional[torch.Tensor] = None):
    """Per-token symmetric int8 activations of ``x`` (..., K), as the JAX
    package forms them (absmax / 127 with a 1e-8 floor, round half to even,
    in fp32): (xq (M, K) int8, x_scale (..., 1) fp32). ``absmax`` (..., 1)
    replaces the row's own absmax (a row-parallel layer's, taken over the
    whole row, ``parallel/tensor.py``)."""
    x32 = x.float()
    if absmax is None:
        absmax = x32.abs().amax(dim=-1, keepdim=True)
    xs = absmax.clamp_min(1e-8) / 127.0
    xq = torch.round(x32 / xs).clamp_(-127, 127).to(torch.int8)
    return xq.reshape(-1, x.shape[-1]), xs


def _int8_matmul(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype, act_quant: bool, act=None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ dequant(kernel int8 (in, out)) with ``scale`` (1, out) fp32, in
    the JAX package's two modes (``arcflow_tpu/models/layers.py:171-195``):

    * weight-only: ``kernel.to(dtype) * scale.to(dtype)`` (the scale cast
      before the product), then the dot in ``dtype``;
    * w8a8: per-token symmetric int8 activations (``_act_int8``, or
      ``act``, its result for this ``x``), the int8 x int8 -> int32
      product (``ops/int8_matmul.py``), then ``y * (x_scale * scale)`` in
      fp32 with the product of the two scales formed first, cast to
      ``out_dtype`` (``dtype`` by default).
    """
    if not act_quant:
        return x.to(dtype) @ (kernel.to(dtype) * scale.to(dtype))
    lead = x.shape[:-1]
    xq, xs = act if act is not None else _act_int8(x)
    y = i8_ops.int8_matmul(xq, kernel)
    return (y.reshape(*lead, -1).float() * (xs * scale.float())).to(
        out_dtype or dtype)


def _int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype, act_quant: bool, act=None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ dequant(packed int4) for the group-local half-split layout
    (``utils/quantize.py:pack_int4``), ``packed`` (in/2, out) int8 and
    ``scale`` (G, 1, out) fp32. Two modes, as in the JAX package:

    * weight-only (``act_quant`` False): two dots in ``dtype`` over the
      nibble halves, ``x_lo . deq(lo) + x_hi . deq(hi)``;
    * w4a8: per-token symmetric int8 activations (absmax / 127, round half
      to even), the grouped matmul (``ops/quant_matmul.py:w4a8_matmul``:
      the Hopper kernel on a CUDA tensor, whatever the token count), then
      ``(y * x_scale)`` cast to ``out_dtype`` (``dtype`` by default),
      which the kernel does in its epilogue (``row_scale``,
      ``out_dtype``); ``act`` as for ``_int8_matmul``.
    """
    g = scale.shape[-3]
    ph = packed.shape[-2] // g                 # packed rows per group
    out = packed.shape[-1]
    lead = x.shape[:-1]
    if act_quant:
        xq, xs = act if act is not None else _act_int8(x)
        y = qmm_ops.w4a8_matmul(xq.contiguous(), packed, scale[:, 0, :],
                                row_scale=xs.reshape(-1, 1),
                                out_dtype=out_dtype or dtype)
        return y.reshape(*lead, out)
    lo, hi = unpack_nibbles(packed)
    sc = scale.to(dtype).expand(g, ph, out).reshape(g * ph, out)
    xr = x.to(dtype).reshape(*lead, g, 2, ph)
    x_lo = xr[..., 0, :].reshape(*lead, g * ph)
    x_hi = xr[..., 1, :].reshape(*lead, g * ph)
    return x_lo @ (lo.to(dtype) * sc) + x_hi @ (hi.to(dtype) * sc)


class LoRADense(nn.Linear):
    """Linear with an optional low-rank adapter: y = x W^T + b + (x A) B
    (LoRA alpha = rank, the only scale the JAX package's configs use).

    ``lora_a`` (in, r) and ``lora_b`` (r, out) keep the JAX layout and are
    made in fp32; every parameter is cast to the compute dtype ``self.dtype``
    per call. ``lora_dropout`` drops the adapter branch's input only (peft's
    LoRA dropout, JAX ``layers.py:210-213``), and only when ``forward`` gets
    a ``generator``: one for the whole input, or one per row
    (``uniform_rows``).

    The kernel is drawn as flax draws it (``lecun_normal_``), the bias is
    zero. After ``quantize_weights_int8`` or ``quantize_weights_int4`` the
    layer has no ``weight``; its kernel lives in the ``kernel`` /
    ``kernel_scale`` or the ``kernel_packed4`` / ``kernel_scale4`` buffers
    (JAX names and shapes; ``parallel/fsdp.py`` shards them over
    ``fsdp``), and ``act_quant`` selects w8a8 or w4a8 over the
    weight-only mode. The bias and the LoRA branch are added after the
    quantized product. Under ``lora_disabled`` the layer is its base alone
    (the tied teacher runs the student's sharded modules so).

    Tensor parallelism (``split_tensor``, by ``parallel/tensor.py:
    set_tensor_parallel``): a 'column' layer takes the whole input and
    returns the list of its shards' outputs; a 'row' layer takes the list
    of its shards' inputs and returns the whole output, summed over the
    shards (``parallel/tensor.py`` states the split of every tensor and
    the gradient convention).
    """

    def __init__(self, in_features: int, out_features: int,
                 lora_rank: int = 0, lora_dropout: float = 0.0, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, device=device,
                         dtype=dtype)
        self.dtype = self.weight.dtype           # compute dtype
        self.act_quant = False
        self.lora_enabled = True
        self.lora_rank = lora_rank
        self.lora_dropout = lora_dropout
        self.tensor_parallel = None
        self.tensor_split = None                 # (kind, segments)
        self._tensor_parts = {}                  # a LocalTensor's kernels
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.empty(
                in_features, lora_rank, device=device, dtype=torch.float32))
            nn.init.normal_(self.lora_a, std=1.0 / lora_rank)
            self.lora_b = nn.Parameter(torch.zeros(
                lora_rank, out_features, device=device, dtype=torch.float32))

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    @property
    def is_int4(self) -> bool:
        return 'kernel_packed4' in self._buffers

    @property
    def is_int8(self) -> bool:
        return 'kernel' in self._buffers

    @property
    def is_quantized(self) -> bool:
        return self.is_int8 or self.is_int4

    @property
    def group_size(self) -> Optional[int]:
        """The int4 scale group (None for another layer)."""
        if not self.is_int4:
            return None
        return self.kernel_packed4.shape[-2] * 2 // \
            self.kernel_scale4.shape[-3]

    def split_names(self):
        """The tensors a split of this layer cuts."""
        kind = self.tensor_split[0]
        return [n for n in tensor_par.SPLIT_DIMS[kind]
                if getattr(self, n, None) is not None]

    def split_tensor(self, tp, kind: str, segments) -> None:
        """Split this layer over ``tp`` (``parallel/tensor.py``): ``kind``
        'column' (over the output features) or 'row' (over the input
        features), each of ``segments`` cut in ``tp.size``. A
        ``TensorGroup`` keeps its rank's part of each tensor; a
        ``LocalTensor`` keeps the whole tensors and, for the quantized
        kernels, each shard's contiguous part beside them."""
        if self.tensor_split is not None:
            raise ValueError('the layer is split already')
        self.tensor_split = (kind, tuple(segments))
        self.tensor_parallel = tp
        gs = self.group_size
        with torch.no_grad():
            for name in self.split_names():
                t = getattr(self, name)
                if tp.holds_parts:
                    part = tensor_par.split_part(t.data, name, kind, segments,
                                                 tp.size, tp.rank, gs)
                    if name in self._parameters:
                        self._parameters[name].data = part
                    else:
                        self._buffers[name] = part
                elif name in self._buffers:
                    self._tensor_parts[name] = [
                        tensor_par.split_part(t, name, kind, segments,
                                              tp.size, i, gs)
                        for i in range(tp.size)]

    def _part(self, name: str, i: int) -> torch.Tensor:
        """Shard ``i``'s part of tensor ``name`` (a view of a float
        parameter under a ``LocalTensor``, so autograd reaches it)."""
        tp = self.tensor_parallel
        if tp.holds_parts:
            return getattr(self, name)
        if name in self._tensor_parts:
            return self._tensor_parts[name][i]
        kind, segments = self.tensor_split
        return tensor_par.split_part(getattr(self, name), name, kind,
                                     segments, tp.size, i, self.group_size,
                                     view=True)

    def _product(self, x, i, dt, act, bias: bool, out_dtype=None):
        """Shard ``i``'s base product (the whole layer's when unsplit),
        with its bias part when ``bias``."""
        part = self._part if self.tensor_split else \
            (lambda n, _: getattr(self, n))
        b = part('bias', i).to(dt) if bias and self.bias is not None \
            else None
        if self.is_int8:
            y = _int8_matmul(x, part('kernel', i), part('kernel_scale', i),
                             dt, self.act_quant, act, out_dtype)
        elif self.is_int4:
            y = _int4_matmul(x, part('kernel_packed4', i),
                             part('kernel_scale4', i), dt, self.act_quant,
                             act, out_dtype)
        else:
            return F.linear(x.to(dt), part('weight', i).to(dt), b)
        return y if b is None else y + b

    def _dropped(self, x, generator, keep=None):
        """The LoRA branch's input: ``x`` with its dropout (``keep``, or a
        mask drawn from ``generator``) when one applies."""
        if self.lora_dropout <= 0.0 or generator is None:
            return x
        keep_prob = 1.0 - self.lora_dropout
        if keep is None:
            keep = uniform_rows(x, generator) < keep_prob
        return torch.where(keep, x / keep_prob, 0.0)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        tp = self.tensor_parallel
        if tp is not None:
            if self.tensor_split[0] == 'column':
                return self._column(x, generator, tp)
            return self._row(x, generator, tp)
        dt = self.dtype
        y = self._product(x, 0, dt, None, bias=True)
        x = x.to(dt)
        if self.lora_rank > 0 and self.lora_enabled:
            x = self._dropped(x, generator)
            y = y + (x @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
        return y

    def _column(self, x, generator, tp):
        dt = self.dtype
        x_in = tp.enter(x)
        act = _act_int8(x) if self.is_quantized and self.act_quant else None
        z = None
        if self.lora_rank > 0 and self.lora_enabled:
            z = tp.enter(self._dropped(x.to(dt), generator)
                         @ self.lora_a.to(dt))
        outs = []
        for i in tp.parts:
            y = self._product(x_in, i, dt, act, bias=True)
            if z is not None:
                y = y + z @ self._part('lora_b', i).to(dt)
            outs.append(y)
        return outs

    def _row(self, xs, generator, tp):
        dt = self.dtype
        segments = self.tensor_split[1]
        acts = [None] * len(xs)
        out_dt = dt
        if self.is_quantized and self.act_quant:
            # the per-token scale of the whole row: the max of the shards'
            # absmax, as the one-device layer takes it
            amax = tp.all_max([x.float().abs().amax(dim=-1, keepdim=True)
                               for x in xs])
            acts = [_act_int8(x, a) for x, a in zip(xs, amax)]
            out_dt = torch.float32
        partials = [self._product(x, i, dt, a, bias=False, out_dtype=out_dt)
                    for x, i, a in zip(xs, tp.parts, acts)]
        lora = self.lora_rank > 0 and self.lora_enabled
        if lora:
            keep = None
            if self.lora_dropout > 0.0 and generator is not None:
                # drawn at the full input width, as on one device, then cut
                shape = (*xs[0].shape[:-1], self.in_features)
                keep = uniform_rows(xs[0], generator, shape) \
                    < 1.0 - self.lora_dropout
            for j, (x, i) in enumerate(zip(xs, tp.parts)):
                k = None if keep is None else tensor_par.take(
                    keep, -1, tensor_par.part_ranges(segments, tp.size, i))
                z = self._dropped(x.to(dt), generator, k) \
                    @ self._part('lora_a', i).to(dt)
                partials[j] = torch.cat([partials[j],
                                         z.to(partials[j].dtype)], dim=-1)
        y = tp.reduce(partials)
        if lora:
            y, z = y.split([self.out_features, self.lora_rank], dim=-1)
        y = y.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        if lora:
            y = y + z.to(dt) @ self.lora_b.to(dt)
        return y


def shard_outputs(y) -> list:
    """A layer's output as the list of its shards' outputs (one, the whole
    output, for a layer that is not column-split)."""
    return y if isinstance(y, list) else [y]


def row_call(layer: LoRADense, parts: list, generator=None) -> torch.Tensor:
    """``layer`` on the list of its shards' inputs: a row-split layer sums
    them, an unsplit one takes the one whole input."""
    if layer.tensor_parallel is not None:
        return layer(parts, generator)
    (x,) = parts
    return layer(x, generator)


def whole_output(layer: LoRADense, x: torch.Tensor, generator=None
                 ) -> torch.Tensor:
    """``layer(x)`` whole: a column-split layer's shards gathered."""
    y = layer(x, generator)
    return layer.tensor_parallel.gather(y) if isinstance(y, list) else y


class DropoutRows(list):
    """The generators of a forward's LoRA dropout, one per batch row
    (``flux.dropout_generator``), for a forward that holds only some tokens
    of the single-device sequence (a sequence-parallel shard, or streams
    padded for ``sp``). ``streams`` maps each token stream of a block
    ('txt', 'img' and their concatenation 'joint') to (index, total): where
    the local tokens sit among the ``total`` tokens of that stream on one
    device (``parallel.mesh.token_streams``); ``stream_rows`` picks one.
    ``tokens`` is the (index, total) of the stream a layer draws for."""

    def __init__(self, generators, streams=None, tokens=None):
        super().__init__(generators)
        self.streams = streams
        self.tokens = tokens


def stream_rows(generator, stream: str):
    """The dropout generators for the tokens of ``stream``: ``generator``
    itself, unless it carries the token streams of a sequence-parallel
    forward (``DropoutRows``)."""
    streams = getattr(generator, 'streams', None)
    if not streams:
        return generator
    return DropoutRows(generator, tokens=streams[stream])


def uniform_rows(x: torch.Tensor, generator, shape=None) -> torch.Tensor:
    """Uniform draws of ``shape`` (``x``'s by default) on ``x``'s device:
    from ``generator``, or, given a sequence of generators (one per row,
    ``flux.dropout_generator``), row i of them from generator i. Where the
    generators say which tokens of the single-device sequence ``x`` holds
    (``DropoutRows.tokens``), each row draws the whole sequence, as on one
    device, and keeps those tokens, so a sequence-parallel rank draws the
    masks of its tokens."""
    shape = tuple(x.shape if shape is None else shape)
    if isinstance(generator, torch.Generator):
        return torch.rand(shape, generator=generator, device=x.device)
    if len(generator) != shape[0]:
        raise ValueError(f'{len(generator)} dropout generators for '
                         f'{shape[0]} rows')
    tokens = getattr(generator, 'tokens', None)
    if tokens is None:
        return torch.stack([torch.rand(shape[1:], generator=g,
                                       device=x.device) for g in generator])
    index, total = tokens
    return torch.stack([torch.rand((total, *shape[2:]), generator=g,
                                   device=x.device).index_select(0, index)
                        for g in generator])


@contextlib.contextmanager
def lora_disabled(module: nn.Module):
    """Run ``module``'s ``LoRADense`` layers without their LoRA branch
    within the block."""
    layers = [m for m in module.modules()
              if isinstance(m, LoRADense) and m.lora_enabled]
    for m in layers:
        m.lora_enabled = False
    try:
        yield module
    finally:
        for m in layers:
            m.lora_enabled = True


def _zero_dense(in_features: int, out_features: int, device=None, dtype=None
                ) -> LoRADense:
    """Dense with zero kernel and bias (the AdaLN-zero modulation init)."""
    layer = LoRADense(in_features, out_features, device=device, dtype=dtype)
    nn.init.zeros_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


class RMSNorm(nn.Module):
    """RMS norm over the last dim (per head on q/k in FLUX attention),
    eps 1e-6; returns ``dtype`` (the input's when None)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + 1e-6) * self.weight.float()
        return out.to(self.dtype or x.dtype)


def layer_norm_no_affine(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim without affine, eps 1e-6, in fp32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


class _SplitModulation(nn.Module):
    """An AdaLN whose modulation may be column-split over the ``tensor``
    axis, its (B, n D) output gathered (JAX ``layers.py:255-286``)."""

    def tensor_plan(self):
        return {'modulation': ('column',
                               (self.modulation.out_features,))}, 0

    def _modulation(self, temb: torch.Tensor) -> torch.Tensor:
        return whole_output(self.modulation, F.silu(temb))


class AdaLayerNormZero(_SplitModulation):
    """LN (no affine) + 6-way modulation from temb (shift/scale/gate x2)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.modulation = _zero_dense(dim, 6 * dim, device, dtype)
        self.tensor_parallel = None

    def forward(self, x: torch.Tensor, temb: torch.Tensor):
        mod = self._modulation(temb)[:, None]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            mod.chunk(6, dim=-1)
        h = layer_norm_no_affine(x) * (1 + scale_msa) + shift_msa
        return h, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroSingle(_SplitModulation):
    """LN (no affine) + 3-way modulation (shift/scale/gate)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.modulation = _zero_dense(dim, 3 * dim, device, dtype)
        self.tensor_parallel = None

    def forward(self, x: torch.Tensor, temb: torch.Tensor):
        shift, scale, gate = self._modulation(temb)[:, None].chunk(3, dim=-1)
        return layer_norm_no_affine(x) * (1 + scale) + shift, gate


class AdaLayerNormContinuous(nn.Module):
    """Final LN with modulation from temb; note the (scale, shift) chunk
    order, reversed against AdaLayerNormZero."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.modulation = _zero_dense(dim, 2 * dim, device, dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.modulation(F.silu(temb))[:, None].chunk(2, dim=-1)
        return layer_norm_no_affine(x) * (1 + scale) + shift


class FeedForward(nn.Module):
    """gelu(tanh) MLP, dim -> mult*dim -> dim (diffusers FeedForward).
    ``moe_experts`` > 0 swaps in the expert-choice ``MoEFeedForward``
    under a ``moe`` child (JAX ``layers.py:303-333``), which takes no LoRA
    and no dropout, as in JAX. Over the ``tensor`` axis ``in_proj`` is
    column- and ``out_proj`` row-split (F / t hidden units a shard); MoE
    blocks there are refused (``parallel/tensor.py``)."""

    def __init__(self, dim: int, lora_rank: int = 0, lora_dropout: float = 0.0,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.0,
                 mult: int = 4, device=None, dtype=None):
        super().__init__()
        if moe_experts > 0:
            self.moe = MoEFeedForward(dim, moe_experts, moe_capacity_factor,
                                      mult=mult, device=device, dtype=dtype)
            return
        self.moe = None
        self.tensor_parallel = None
        kw = dict(lora_rank=lora_rank, lora_dropout=lora_dropout,
                  device=device, dtype=dtype)
        self.in_proj = LoRADense(dim, mult * dim, **kw)
        self.out_proj = LoRADense(mult * dim, dim, **kw)

    def tensor_plan(self):
        if self.moe is not None:
            raise NotImplementedError(
                f'MoE blocks under the tensor axis (JAX\'s experts_hidden '
                f'split) are not ported yet (ROADMAP.md queue A item '
                f'{tensor_par.MOE_UNDER_TENSOR})')
        hidden = (self.in_proj.out_features,)
        return {'in_proj': ('column', hidden),
                'out_proj': ('row', hidden)}, 0

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.moe is not None:
            return self.moe(x)
        h = [F.gelu(p, approximate='tanh')
             for p in shard_outputs(self.in_proj(x, generator))]
        return row_call(self.out_proj, h, generator)


def _lecun_normal_fan_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal`` in place for a parameter whose fan-in is not
    its first axis' complement: flax counts every axis but the last two as
    receptive field, so a (E, D, F) expert stack has fan-in E x D."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class MoEFeedForward(nn.Module):
    """Mixture-of-experts FFN with expert-choice routing (JAX
    ``layers.py:336-402``).

    Each of the E experts picks its top-C tokens of each sample, C =
    ``max(1, int(S * capacity_factor) // E)`` (JAX's integer arithmetic);
    a token may be picked by several experts, weighted by the router's
    softmax score, or by none, and then gets 0 (the block's residual
    carries it). Parameters keep JAX's names and layouts, all fp32 and
    cast to the compute dtype ``dtype`` on use: ``router`` (D, E),
    ``w_in`` (E, D, F), ``b_in`` (E, F), ``w_out`` (E, F, D), ``b_out``
    (E, D). The router's math is fp32.

    JAX dispatches with a (B, E, C, S) one-hot einsum (the MXU form);
    here the picked tokens are gathered by index and the gate-weighted
    expert outputs are scatter-added back, the same sums. The top-C is a
    stable descending sort, so tied scores go to the lower token index,
    as ``lax.top_k`` breaks them. JAX sums the experts' contributions in
    the compute dtype (``einsum('becs,becd,bec->bsd')``); here they are
    summed in fp32 and cast once, which in bf16 differs from JAX by the
    rounding of that sum (``tests/test_torch_moe.py`` states the bound).

    Expert parallelism: with ``expert_parallel`` (a
    ``parallel.expert.ExpertParallel``, set by ``partition_experts``) the
    module holds only its rank's experts (``expert_offset`` is the first)
    and their outputs are summed over the group (``parallel/expert.py``
    states the gradient convention).
    """

    def __init__(self, dim: int, num_experts: int,
                 capacity_factor: float = 1.0, mult: int = 4, device=None,
                 dtype=None):
        super().__init__()
        e, hidden = num_experts, dim * mult
        self.dim, self.num_experts = dim, num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.expert_parallel = None
        self.expert_offset = 0
        f32 = dict(device=device, dtype=torch.float32)
        self.router = nn.Parameter(torch.empty(dim, e, **f32))
        self.w_in = nn.Parameter(torch.empty(e, dim, hidden, **f32))
        self.b_in = nn.Parameter(torch.zeros(e, hidden, **f32))
        self.w_out = nn.Parameter(torch.empty(e, hidden, dim, **f32))
        self.b_out = nn.Parameter(torch.zeros(e, dim, **f32))
        _lecun_normal_fan_(self.router, dim)
        _lecun_normal_fan_(self.w_in, e * dim)
        _lecun_normal_fan_(self.w_out, e * hidden)

    def capacity(self, s: int) -> int:
        return max(1, int(s * self.capacity_factor) // self.num_experts)

    def partition_experts(self, ep) -> None:
        """Keep only the experts ``ep`` (an ``ExpertParallel``) gives this
        rank, and sum their outputs over its group from now on."""
        lo, hi = ep.experts(self.num_experts)
        with torch.no_grad():
            for p in (self.w_in, self.b_in, self.w_out, self.b_out):
                p.data = p.data[lo:hi].clone()
        self.expert_parallel, self.expert_offset = ep, lo

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        c = self.capacity(s)
        if c > s:
            raise ValueError(f'capacity {c} of {self.num_experts} experts at '
                             f'factor {self.capacity_factor} exceeds the '
                             f'{s} tokens (lax.top_k refuses it too)')
        dt = self.dtype or x.dtype
        ep = self.expert_parallel
        scores = torch.softmax(x.float() @ self.router.float(), dim=-1)
        xd = x.to(dt)
        if ep is not None:
            scores, xd = ep.replicate(scores), ep.replicate(xd)
        n = self.w_in.shape[0]                          # experts held here
        own = scores[..., self.expert_offset:self.expert_offset + n]
        own = own.transpose(1, 2)                        # (B, E, S)
        idx = torch.sort(own.detach(), dim=-1, descending=True,
                         stable=True).indices[..., :c]   # (B, E, C)
        gates = own.gather(-1, idx)
        flat = idx.reshape(b, n * c, 1).expand(b, n * c, d)
        xin = xd.gather(1, flat).reshape(b, n, c, d)
        h = torch.einsum('becd,edf->becf', xin, self.w_in.to(dt))
        h = F.gelu(h + self.b_in.to(dt)[None, :, None], approximate='tanh')
        out = torch.einsum('becf,efd->becd', h, self.w_out.to(dt))
        out = (out + self.b_out.to(dt)[None, :, None]) \
            * gates.to(dt)[..., None]
        y = torch.zeros(b, s, d, dtype=torch.float32, device=x.device)
        y = y.scatter_add(1, flat, out.reshape(b, n * c, d).float())
        if ep is not None:
            y = ep.combine(y)
        return y.to(dt)


# ---- rotary embeddings ------------------------------------------------------

def rope_frequencies(ids: torch.Tensor, axes_dim: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-axis rotary cos/sin (S, sum(axes_dim)) for (S, n_axes) position
    ids, theta 10000, each frequency repeated twice (pair-interleaved)."""
    coss, sins = [], []
    for i, d in enumerate(axes_dim):
        half = d // 2
        freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                                device=ids.device) * 2 / d))
        angles = ids[:, i:i + 1].float() * freqs[None]               # (S, half)
        coss.append(torch.repeat_interleave(torch.cos(angles), 2, dim=-1))
        sins.append(torch.repeat_interleave(torch.sin(angles), 2, dim=-1))
    return torch.cat(coss, dim=-1), torch.cat(sins, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Pairwise rotation in the interleaved layout, x (..., S, D), in fp32:
    ``x_rot[2i] = -x[2i+1], x_rot[2i+1] = x[2i]``. (The JAX package's
    lane-roll form gives the same bits and exists for TPU tiling.)"""
    x32 = x.float()
    pairs = x32.reshape(*x32.shape[:-1], -1, 2)
    x_rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(
        x32.shape)
    return (x32 * cos + x_rot * sin).to(x.dtype)


# ---- attention ----------------------------------------------------------------

def key_padding_mask(mask: Optional[torch.Tensor], s_kv: int
                     ) -> Optional[torch.Tensor]:
    """(B, S_kv) bool key validity when ``mask`` is a key-only padding mask
    (B, 1, 1, S_kv) broadcast over queries and heads, else None."""
    if mask is None:
        return None
    if (mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1
            and mask.shape[-1] == s_kv):
        return mask[:, 0, 0, :].bool()
    return None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, sp=None) -> torch.Tensor:
    """Scaled dot-product attention on (B, S, H, D) tensors.

    The backend follows the tensors' device: a CUDA tensor runs the Hopper
    kernels (``ops/attention.py:flash_attention``, forward and, under
    autograd, backward), a CPU tensor their plain versions. ``mask`` may be
    None or a key-padding mask (B, 1, 1, S_kv); other masks raise.

    ``sp`` routes the call over the sequence-parallel ranks, forward and,
    under autograd, backward: a ``LocalRing`` or a ``SequenceParallel`` in
    'ring' mode runs ``parallel/ring_attention.py`` on this rank's token
    shard (K4 hops, K3 hops in the backward); one in 'ulysses' mode turns
    the token shards into head shards of the full sequence (all-to-all,
    whose backward is the inverse all-to-all), runs the kernels (K1 / K2,
    K3) on them with the key mask gathered from every rank, and turns them
    back.

    A batch row whose keys are all masked gets what the JAX ``attention``
    gives it (XLA attention masks with a large negative number, so the row
    attends uniformly to every key): O = the mean of v over the keys, so
    dv = sum_q dO / S_kv and dq = dk = 0 from that row. The kernels'
    contract for such a row stays O = 0, LSE = -inf; the replacement is a
    ``torch.where`` on the device, with no host sync.
    """
    kv_valid = key_padding_mask(mask, k.shape[1])
    if mask is not None and kv_valid is None:
        raise ValueError('attention takes only key-padding masks '
                         f'(B, 1, 1, S_kv), got {tuple(mask.shape)}')
    if sp is None:
        return _attention_one_device(q, k, v, kv_valid)
    if isinstance(sp, LocalRing) or sp.mode == 'ring':
        return ring_attention(q, k, v, kv_valid, sp)
    q, k, v = (sp.seq_to_heads(t) for t in (q, k, v))
    if kv_valid is not None:
        kv_valid = sp.gather(kv_valid)
    return sp.heads_to_seq(_attention_one_device(q, k, v, kv_valid))


def _attention_one_device(q, k, v, kv_valid):
    out = attn_ops.flash_attention(q, k, v, kv_valid)
    if kv_valid is None:
        return out
    has_key = kv_valid.any(dim=1)[:, None, None, None]
    v_mean = v.mean(dim=1, keepdim=True, dtype=torch.float32)
    return torch.where(has_key, out, v_mean.to(out.dtype))


class JointAttention(nn.Module):
    """FLUX dual-stream joint attention: separate qkv per stream, per-head
    q/k RMSNorm per stream before the [txt, img] concat, RoPE after it.
    Over the ``tensor`` axis (``tensor_parallel``) each shard runs H / t
    heads: q / k / v column-split, the out projections row-split."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 lora_rank: int = 0, device=None, dtype=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.sequence_parallel = None
        self.tensor_parallel = None
        inner = num_heads * head_dim
        kw = dict(lora_rank=lora_rank, device=device, dtype=dtype)
        for s in ('img', 'txt'):
            for p in ('q', 'k', 'v'):
                self.add_module(f'{s}_{p}', LoRADense(dim, inner, **kw))
            for p in ('q', 'k'):
                self.add_module(f'{s}_{p}_norm',
                                RMSNorm(head_dim, device=device, dtype=dtype))
            self.add_module(f'{s}_out', LoRADense(inner, dim, **kw))

    def tensor_plan(self):
        inner = (self.num_heads * self.head_dim,)
        plan = {f'{s}_{p}': ('column', inner)
                for s in ('img', 'txt') for p in ('q', 'k', 'v')}
        plan.update({f'{s}_out': ('row', inner) for s in ('img', 'txt')})
        return plan, self.num_heads

    def forward(self, img: torch.Tensor, txt: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor],
                mask: Optional[torch.Tensor] = None):
        b, s_img, _ = img.shape
        s_txt = txt.shape[1]

        def heads(x, name, norm=None):
            parts = shard_outputs(getattr(self, name)(x))
            parts = [p.reshape(b, x.shape[1], -1, self.head_dim)
                     for p in parts]
            return parts if norm is None else \
                [getattr(self, norm)(p) for p in parts]

        q_i = heads(img, 'img_q', 'img_q_norm')
        k_i = heads(img, 'img_k', 'img_k_norm')
        v_i = heads(img, 'img_v')
        q_t = heads(txt, 'txt_q', 'txt_q_norm')
        k_t = heads(txt, 'txt_k', 'txt_k_norm')
        v_t = heads(txt, 'txt_v')

        # joint sequence: [txt, img]; one attention per head shard
        cos, sin = (r[None, :, None, :] for r in rope)
        outs = []
        for j in range(len(q_i)):
            q = apply_rope(torch.cat([q_t[j], q_i[j]], dim=1), cos, sin)
            k = apply_rope(torch.cat([k_t[j], k_i[j]], dim=1), cos, sin)
            v = torch.cat([v_t[j], v_i[j]], dim=1)
            outs.append(attention(q, k, v, mask=mask,
                                  sp=self.sequence_parallel
                                  ).reshape(b, s_txt + s_img, -1))
        return (row_call(self.img_out, [o[:, s_txt:] for o in outs]),
                row_call(self.txt_out, [o[:, :s_txt] for o in outs]))


class SingleStreamAttention(nn.Module):
    """Attention half of the FLUX single block (no output projection: the
    block fuses attn + mlp through one proj_out). Split over the
    ``tensor`` axis by its block (``FluxSingleBlock.tensor_plan``), it
    returns the list of its head shards' outputs."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 lora_rank: int = 0, device=None, dtype=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.sequence_parallel = None
        inner = num_heads * head_dim
        kw = dict(lora_rank=lora_rank, device=device, dtype=dtype)
        self.q = LoRADense(dim, inner, **kw)
        self.k = LoRADense(dim, inner, **kw)
        self.v = LoRADense(dim, inner, **kw)
        self.q_norm = RMSNorm(head_dim, device=device, dtype=dtype)
        self.k_norm = RMSNorm(head_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor],
                mask: Optional[torch.Tensor] = None):
        b, s, _ = x.shape
        cos, sin = (r[None, :, None, :] for r in rope)

        def heads(y):
            return [p.reshape(b, s, -1, self.head_dim)
                    for p in shard_outputs(y)]

        qs, ks, vs = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        outs = [attention(apply_rope(self.q_norm(q), cos, sin),
                          apply_rope(self.k_norm(k), cos, sin), v, mask=mask,
                          sp=self.sequence_parallel).reshape(b, s, -1)
                for q, k, v in zip(qs, ks, vs)]
        return outs if self.q.tensor_parallel is not None else outs[0]
