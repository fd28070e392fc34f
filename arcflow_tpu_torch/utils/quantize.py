"""Weight quantization for serving: per-channel int8 and group-wise int4.

Counterpart of ``arcflow_tpu/utils/quantize.py``. ``quantize_weights_int8``
and ``quantize_weights_int4`` apply the JAX package's skip rules to a
module's ``LoRADense`` layers; ``pack_int4``/``unpack_int4`` keep its
group-local half-split layout byte for byte. A quantized layer keeps the
JAX names and shapes:

* int8: ``kernel`` (in, out) int8, stored column-major (the bytes of an
  (out, in) row-major matrix, what the GEMM reads for ``x @ W^T`` without
  a copy), and ``kernel_scale`` (1, out) fp32, one scale per output
  channel;
* int4: ``kernel_packed4`` (in/2, out) int8, two nibbles per byte, and
  ``kernel_scale4`` (in/g, 1, out) fp32, one scale per (input group x
  output channel), both row-major as in JAX.

The JAX package's process-wide ``set_act_quant``/``set_serving`` flags are
not ported: whether a layer quantizes its activations (w8a8, w4a8) is its
own ``act_quant`` attribute, set here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

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


def quantize_kernel_int8(kernel: torch.Tensor):
    """(in, out) kernel -> (int8 (in, out), scale (1, out) fp32): symmetric
    per output channel, absmax over the input axis, max(absmax, 1e-8) / 127,
    round half to even, clip to [-127, 127], all in fp32 as in the JAX
    package. The int8 kernel is column-major (``kernel.t()`` is
    contiguous)."""
    kf = kernel.float()
    scale = kf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(kf / scale).clamp_(-127, 127).to(torch.int8)
    return q.t().contiguous().t(), scale.contiguous()


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


def _skip(key: str, layer: nn.Module, min_size: int,
          group_size: Optional[int] = None) -> bool:
    """The JAX skip rules: the adapter surface, kernels below ``min_size``
    and, for int4 (``group_size``), inputs that do not split into groups."""
    w = layer.weight
    return (any(s in key for s in _SKIP_SUBSTRINGS)
            or any(key.startswith(p) for p in _SKIP_PREFIXES)
            or w.numel() < min_size
            or (group_size is not None
                and (w.shape[1] % group_size != 0 or group_size % 2 != 0)))


def _float_layers(module: nn.Module):
    """(name, layer) of each ``LoRADense`` that still has a float kernel."""
    from ..models.layers import LoRADense
    for name, layer in module.named_modules():
        if isinstance(layer, LoRADense) and not layer.is_quantized:
            yield name, layer


def quantize_weights_int8(module: nn.Module, min_size: int = 2 ** 16,
                          act_quant: bool = False) -> List[str]:
    """Quantize ``module``'s ``LoRADense`` kernels to int8 in place.

    Each layer that passes the JAX package's skip rules (adapter surface,
    ``min_size``) loses its ``weight`` and gains the ``kernel`` and
    ``kernel_scale`` buffers, one layer at a time, so a bf16 trunk never
    needs room for a second copy of itself. ``act_quant`` selects w8a8
    (per-token int8 activations, an int8 x int8 -> int32 product) over
    weight-only int8. ``min_size`` counts one layer's kernel; the JAX
    package counts a scanned stack of them, which decides differently only
    for a block kernel smaller than ``min_size`` whose stack is not.
    Returns the names of the quantized layers.
    """
    done = []
    for name, layer in list(_float_layers(module)):
        if _skip(f'{name}.kernel', layer, min_size):
            continue
        with torch.no_grad():
            kernel, scale = quantize_kernel_int8(layer.weight.t())
        del layer.weight
        layer.register_buffer('kernel', kernel)
        layer.register_buffer('kernel_scale', scale)
        layer.act_quant = act_quant
        done.append(name)
    return done


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
    done = []
    for name, layer in list(_float_layers(module)):
        if _skip(f'{name}.kernel', layer, min_size, group_size):
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
    """Inverse transform on a state dict: every int8 ``kernel`` /
    ``kernel_scale`` pair and every ``kernel_packed4`` / ``kernel_scale4``
    pair becomes an fp32 ``weight`` (out, in) again."""
    quant = ('.kernel', '.kernel_scale', '.kernel_packed4', '.kernel_scale4')
    out = {k: v for k, v in state.items() if not k.endswith(quant)}
    for key, kernel in state.items():
        if key.endswith('.kernel'):
            stem = key[:-len('.kernel')]
            w = kernel.float() * state[stem + '.kernel_scale'].float()
            out[stem + '.weight'] = w.t().contiguous()
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
