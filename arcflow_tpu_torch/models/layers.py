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
``parallel.LocalRing``), set by ``parallel.set_sequence_parallel``; MoE
waits for its slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops
from ..ops import int8_matmul as i8_ops
from ..ops import quant_matmul as qmm_ops
from ..parallel.ring_attention import (LocalRing, check_no_autograd,
                                       ring_attention)
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


def _int8_matmul(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype, act_quant: bool) -> torch.Tensor:
    """x @ dequant(kernel int8 (in, out)) with ``scale`` (1, out) fp32, in
    the JAX package's two modes (``arcflow_tpu/models/layers.py:171-195``):

    * weight-only: ``kernel.to(dtype) * scale.to(dtype)`` (the scale cast
      before the product), then the dot in ``dtype``;
    * w8a8: per-token symmetric int8 activations (absmax / 127 with a 1e-8
      floor, round half to even, in fp32), the int8 x int8 -> int32 product
      (``ops/int8_matmul.py``), then ``y * (x_scale * scale)`` in fp32 with
      the product of the two scales formed first, cast to ``dtype``.
    """
    if not act_quant:
        return x.to(dtype) @ (kernel.to(dtype) * scale.to(dtype))
    lead = x.shape[:-1]
    x32 = x.float()
    xs = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    xq = torch.round(x32 / xs).clamp_(-127, 127).to(torch.int8)
    y = i8_ops.int8_matmul(xq.reshape(-1, x.shape[-1]), kernel)
    return (y.reshape(*lead, -1).float() * (xs * scale.float())).to(dtype)


def _int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype, act_quant: bool) -> torch.Tensor:
    """x @ dequant(packed int4) for the group-local half-split layout
    (``utils/quantize.py:pack_int4``), ``packed`` (in/2, out) int8 and
    ``scale`` (G, 1, out) fp32. Two modes, as in the JAX package:

    * weight-only (``act_quant`` False): two dots in ``dtype`` over the
      nibble halves, ``x_lo . deq(lo) + x_hi . deq(hi)``;
    * w4a8: per-token symmetric int8 activations (absmax / 127, round half
      to even), the grouped matmul (``ops/quant_matmul.py:w4a8_matmul``:
      the Hopper kernel on a CUDA tensor, whatever the token count), then
      ``(y * x_scale)`` cast to ``dtype``, which the kernel does in its
      epilogue (``row_scale``, ``out_dtype``).
    """
    g = scale.shape[-3]
    ph = packed.shape[-2] // g                 # packed rows per group
    out = packed.shape[-1]
    lead = x.shape[:-1]
    if act_quant:
        x32 = x.float()
        xs = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
        xq = torch.round(x32 / xs).clamp_(-127, 127).to(torch.int8)
        y = qmm_ops.w4a8_matmul(xq.reshape(-1, x.shape[-1]).contiguous(),
                                packed, scale[:, 0, :],
                                row_scale=xs.reshape(-1, 1), out_dtype=dtype)
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
    a ``generator``.

    The kernel is drawn as flax draws it (``lecun_normal_``), the bias is
    zero. After ``quantize_weights_int8`` or ``quantize_weights_int4`` the
    layer has no ``weight``; its kernel lives in the ``kernel`` /
    ``kernel_scale`` or the ``kernel_packed4`` / ``kernel_scale4`` buffers
    (JAX names and shapes), and ``act_quant`` selects w8a8 or w4a8 over the
    weight-only mode. The bias and the LoRA branch are added after the
    quantized product.
    """

    def __init__(self, in_features: int, out_features: int,
                 lora_rank: int = 0, lora_dropout: float = 0.0, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, device=device,
                         dtype=dtype)
        self.dtype = self.weight.dtype           # compute dtype
        self.act_quant = False
        self.lora_rank = lora_rank
        self.lora_dropout = lora_dropout
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

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.is_quantized:
            if self.is_int8:
                y = _int8_matmul(x, self.kernel, self.kernel_scale, dt,
                                 self.act_quant)
            else:
                y = _int4_matmul(x, self.kernel_packed4, self.kernel_scale4,
                                 dt, self.act_quant)
            if bias is not None:
                y = y + bias
            x = x.to(dt)
        else:
            x = x.to(dt)
            y = F.linear(x, self.weight.to(dt), bias)
        if self.lora_rank > 0:
            if self.lora_dropout > 0.0 and generator is not None:
                keep_prob = 1.0 - self.lora_dropout
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) < keep_prob
                x = torch.where(keep, x / keep_prob, 0.0)
            y = y + (x @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
        return y


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


class AdaLayerNormZero(nn.Module):
    """LN (no affine) + 6-way modulation from temb (shift/scale/gate x2)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.modulation = _zero_dense(dim, 6 * dim, device, dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor):
        mod = self.modulation(F.silu(temb))[:, None]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            mod.chunk(6, dim=-1)
        h = layer_norm_no_affine(x) * (1 + scale_msa) + shift_msa
        return h, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroSingle(nn.Module):
    """LN (no affine) + 3-way modulation (shift/scale/gate)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.modulation = _zero_dense(dim, 3 * dim, device, dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor):
        shift, scale, gate = self.modulation(F.silu(temb))[:, None].chunk(
            3, dim=-1)
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
    """gelu(tanh) MLP, dim -> 4*dim -> dim (dense; MoE is not ported)."""

    def __init__(self, dim: int, lora_rank: int = 0, lora_dropout: float = 0.0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(lora_rank=lora_rank, lora_dropout=lora_dropout,
                  device=device, dtype=dtype)
        self.in_proj = LoRADense(dim, 4 * dim, **kw)
        self.out_proj = LoRADense(4 * dim, dim, **kw)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.gelu(self.in_proj(x, generator), approximate='tanh')
        return self.out_proj(h, generator)


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

    ``sp`` routes the call over the sequence-parallel ranks (inference
    only): a ``LocalRing`` or a ``SequenceParallel`` in 'ring' mode runs
    ``parallel/ring_attention.py`` on this rank's token shard; one in
    'ulysses' mode turns the token shards into head shards of the full
    sequence (all-to-all), runs the kernel on them with the key mask
    gathered from every rank, and turns them back.

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
    check_no_autograd(q, k, v)
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
    q/k RMSNorm per stream before the [txt, img] concat, RoPE after it."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 lora_rank: int = 0, device=None, dtype=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.sequence_parallel = None
        inner = num_heads * head_dim
        kw = dict(lora_rank=lora_rank, device=device, dtype=dtype)
        for s in ('img', 'txt'):
            for p in ('q', 'k', 'v'):
                self.add_module(f'{s}_{p}', LoRADense(dim, inner, **kw))
            for p in ('q', 'k'):
                self.add_module(f'{s}_{p}_norm',
                                RMSNorm(head_dim, device=device, dtype=dtype))
            self.add_module(f'{s}_out', LoRADense(inner, dim, **kw))

    def forward(self, img: torch.Tensor, txt: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor],
                mask: Optional[torch.Tensor] = None):
        b, s_img, _ = img.shape
        s_txt = txt.shape[1]

        def heads(x, name):
            return getattr(self, name)(x).reshape(
                b, x.shape[1], self.num_heads, self.head_dim)

        q_i = self.img_q_norm(heads(img, 'img_q'))
        k_i = self.img_k_norm(heads(img, 'img_k'))
        v_i = heads(img, 'img_v')
        q_t = self.txt_q_norm(heads(txt, 'txt_q'))
        k_t = self.txt_k_norm(heads(txt, 'txt_k'))
        v_t = heads(txt, 'txt_v')

        # joint sequence: [txt, img]
        cos, sin = (r[None, :, None, :] for r in rope)
        q = apply_rope(torch.cat([q_t, q_i], dim=1), cos, sin)
        k = apply_rope(torch.cat([k_t, k_i], dim=1), cos, sin)
        v = torch.cat([v_t, v_i], dim=1)
        out = attention(q, k, v, mask=mask, sp=self.sequence_parallel
                        ).reshape(b, s_txt + s_img, -1)
        return self.img_out(out[:, s_txt:]), self.txt_out(out[:, :s_txt])


class SingleStreamAttention(nn.Module):
    """Attention half of the FLUX single block (no output projection: the
    block fuses attn + mlp through one proj_out)."""

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
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        shape = (b, s, self.num_heads, self.head_dim)
        cos, sin = (r[None, :, None, :] for r in rope)
        q = apply_rope(self.q_norm(self.q(x).reshape(shape)), cos, sin)
        k = apply_rope(self.k_norm(self.k(x).reshape(shape)), cos, sin)
        v = self.v(x).reshape(shape)
        return attention(q, k, v, mask=mask, sp=self.sequence_parallel
                         ).reshape(b, s, -1)
