"""Group-wise int4 weight quantization for serving.

Counterpart of the int4 half of ``arcflow_tpu/utils/quantize.py``:
``pack_int4``/``unpack_int4`` keep the JAX package's group-local half-split
layout byte for byte, and ``quantize_weights_int4`` applies its skip rules
to a module's ``LoRADense`` layers. A quantized layer keeps the JAX names
and layout (not transposed):

* ``kernel_packed4`` (in/2, out) int8, two nibbles per byte;
* ``kernel_scale4`` (in/g, 1, out) fp32, one scale per (input group x
  output channel).

The JAX package's process-wide ``set_act_quant``/``set_serving`` flags are
not ported: whether a layer quantizes its activations (w4a8) is its own
``act_quant`` attribute, set here. The int8 and w8a8 paths wait for their
slice.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

# leaves that stay high-precision: the ArcFlow trainable surface (heads,
# LoRA, final AdaLN); in-block modulations are frozen trunk and quantize
_SKIP_SUBSTRINGS = ('proj_out_means', 'proj_out_logweights',
                    'proj_out_loggamma', 'lora_a', 'lora_b')
_SKIP_PREFIXES = ('norm_out.',)


def pack_int4(q: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Integer values in [-8, 7], (..., in, out) -> int8 (..., in/2, out).

    Within each ``group_size``-row scale group, row ``j`` goes to the low
    nibble and row ``j + group_size // 2`` to the high nibble of packed row
    ``j``, so both nibbles of a byte share one scale group. The result is
    contiguous, whatever the strides of ``q``."""
    q = q.to(torch.int8).contiguous()
    h = group_size // 2
    qg = q.reshape(*q.shape[:-2], -1, 2, h, q.shape[-1])
    lo, hi = qg[..., 0, :, :], qg[..., 1, :, :]
    p = (hi << 4) | (lo & 0x0F)
    return p.reshape(*q.shape[:-2], q.shape[-2] // 2, q.shape[-1])


def unpack_nibbles(packed: torch.Tensor):
    """Sign-extended low and high nibbles of an int8 tensor, as int8."""
    p = packed.to(torch.int16)
    lo = ((p & 0x0F) ^ 0x08) - 0x08
    return lo.to(torch.int8), (p >> 4).to(torch.int8)


def unpack_int4(packed: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 (..., in/2, out) -> int8
    (..., in, out)."""
    h = group_size // 2
    pg = packed.reshape(*packed.shape[:-2], -1, h, packed.shape[-1])
    lo, hi = unpack_nibbles(pg)
    return torch.stack([lo, hi], dim=-3).reshape(
        *packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])


def quantize_kernel_int4(kernel: torch.Tensor, group_size: int = 128):
    """(in, out) kernel -> (packed (in/2, out) int8, scale (in/g, 1, out)
    fp32): symmetric per (input group x output channel), absmax / 7,
    round half to even, clip to [-7, 7], all in fp32 as in the JAX
    package."""
    kf = kernel.float().contiguous()    # (in, out) in memory, as in JAX
    g = kf.shape[-2] // group_size
    kg = kf.reshape(g, group_size, kf.shape[-1])
    scale = kg.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 7.0
    q = torch.round(kg / scale).clamp_(-7, 7).reshape(kf.shape)
    return pack_int4(q, group_size), scale


def _skip(key: str, layer: nn.Module, min_size: int, group_size: int
          ) -> bool:
    w = layer.weight
    return (any(s in key for s in _SKIP_SUBSTRINGS)
            or any(key.startswith(p) for p in _SKIP_PREFIXES)
            or w.numel() < min_size
            or w.shape[1] % group_size != 0 or group_size % 2 != 0)


def quantize_weights_int4(module: nn.Module, min_size: int = 2 ** 16,
                          group_size: int = 128, act_quant: bool = False
                          ) -> List[str]:
    """Quantize ``module``'s ``LoRADense`` kernels to int4 in place.

    Each layer that passes the JAX package's skip rules (adapter surface,
    ``min_size``, ``in % group_size``) loses its ``weight`` and gains the
    ``kernel_packed4`` and ``kernel_scale4`` buffers, one layer at a time,
    so a bf16 trunk never needs room for a second copy of itself.
    ``act_quant`` selects w4a8 (per-token int8 activations through the
    grouped-matmul kernel) over weight-only int4. ``min_size`` counts one
    layer's kernel; the JAX package counts a scanned stack of them, which
    decides differently only for a block kernel smaller than ``min_size``
    whose stack is not. Returns the names of the quantized layers.
    """
    from ..models.layers import LoRADense
    done = []
    for name, layer in module.named_modules():
        if not isinstance(layer, LoRADense) or layer.is_int4:
            continue
        key = f'{name}.kernel'
        if _skip(key, layer, min_size, group_size):
            continue
        with torch.no_grad():
            packed, scale = quantize_kernel_int4(layer.weight.t(), group_size)
        del layer.weight
        layer.register_buffer('kernel_packed4', packed)
        layer.register_buffer('kernel_scale4', scale)
        layer.act_quant = act_quant
        done.append(name)
    return done


def dequantize_weights(state: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Inverse transform on a state dict: every ``kernel_packed4`` /
    ``kernel_scale4`` pair becomes an fp32 ``weight`` (out, in) again."""
    out = {k: v for k, v in state.items()
           if not k.endswith(('.kernel_packed4', '.kernel_scale4'))}
    for key, packed in state.items():
        if not key.endswith('.kernel_packed4'):
            continue
        stem = key[:-len('.kernel_packed4')]
        scale = state[stem + '.kernel_scale4'].float()    # (g, 1, out)
        g = scale.shape[-3]
        q = unpack_int4(packed, packed.shape[-2] * 2 // g).float()
        w = (q.reshape(g, -1, q.shape[-1]) * scale).reshape(q.shape)
        out[stem + '.weight'] = w.t().contiguous()
    return out
