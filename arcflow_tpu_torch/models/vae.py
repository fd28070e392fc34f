"""AutoencoderKL decoder (SD/FLUX-style VAE) and its latent denormalization.

Counterpart of ``arcflow_tpu/models/vae.py`` (``ResnetBlock``, ``AttnBlock``,
``Upsample``, ``Decoder`` and ``PretrainedVAE._denormalize``/``decode``).
The public layout is the JAX package's, channel last: ``decode`` takes
(B, h, w, C) latents and returns (B, H, W, 3) images; inside, the convs run
NCHW. GroupNorms compute in fp32, as in the JAX package. Convs and linears
are drawn as flax's ``nn.Conv``/``nn.Dense`` defaults draw them (truncated
LeCun normal, zero bias: ``flax_init_``). The encoder and the quant convs
wait for their slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import lecun_normal_


class GroupNorm32(nn.GroupNorm):
    """32-group GroupNorm (eps 1e-6) with fp32 parameters and math; returns
    fp32 like the JAX package's ``nn.GroupNorm(dtype=float32)``."""

    def __init__(self, channels: int, device=None):
        super().__init__(32, channels, eps=1e-6, device=device,
                         dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)


def flax_init_(layer: nn.Module) -> nn.Module:
    """A conv or linear layer with flax's default init: truncated LeCun
    normal kernel, zero bias."""
    with torch.no_grad():
        lecun_normal_(layer.weight)
        nn.init.zeros_(layer.bias)
    return layer


def _conv(in_ch: int, out_ch: int, k: int, device=None, dtype=None):
    return flax_init_(nn.Conv2d(in_ch, out_ch, k, padding=k // 2,
                                device=device, dtype=dtype))


def _run(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a conv or linear layer in its parameter dtype."""
    return layer(x.to(layer.weight.dtype))


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, device=None,
                 dtype=None):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, device)
        self.conv1 = _conv(in_channels, out_channels, 3, device, dtype)
        self.norm2 = GroupNorm32(out_channels, device)
        self.conv2 = _conv(out_channels, out_channels, 3, device, dtype)
        self.conv_shortcut = _conv(in_channels, out_channels, 1, device,
                                   dtype) if in_channels != out_channels \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _run(self.conv1, F.silu(self.norm1(x)))
        h = _run(self.conv2, F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = _run(self.conv_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial positions (VAE mid block):
    plain matmul + fp32 softmax, no kernel."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.group_norm = GroupNorm32(channels, device)
        for name in ('to_q', 'to_k', 'to_v', 'to_out'):
            self.add_module(name, flax_init_(nn.Linear(channels, channels,
                                                       **kw)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hs = self.group_norm(x).flatten(2).transpose(1, 2)         # (B, HW, C)
        q, k, v = (_run(f, hs) for f in (self.to_q, self.to_k, self.to_v))
        logits = torch.matmul(q, k.transpose(1, 2)).float() / math.sqrt(c)
        attn = torch.matmul(logits.softmax(dim=-1).to(v.dtype), v)
        out = self.to_out(attn).transpose(1, 2).reshape(b, c, h, w)
        return x + out


class Upsample(nn.Module):
    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.conv = _conv(channels, channels, 3, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run(self.conv, F.interpolate(x, scale_factor=2.0,
                                             mode='nearest'))


class Decoder(nn.Module):
    """Latents (B, C, h, w) -> RGB images (B, 3, H, W), upsampled 2x between
    levels (8x for FLUX's four); three resnets per level (diffusers'
    layers_per_block 2, plus one)."""

    def __init__(self, latent_channels: int = 16,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch = list(reversed(block_out_channels))        # (512, 512, 256, 128)
        self.conv_in = _conv(latent_channels, ch[0], 3, **kw)
        self.mid_res_1 = ResnetBlock(ch[0], ch[0], **kw)
        self.mid_attn = AttnBlock(ch[0], **kw)
        self.mid_res_2 = ResnetBlock(ch[0], ch[0], **kw)
        self.up_names = []
        prev = ch[0]
        for i, c in enumerate(ch):
            for j in range(3):
                self.add_module(f'up_{i}_res_{j}', ResnetBlock(prev, c, **kw))
                self.up_names.append(f'up_{i}_res_{j}')
                prev = c
            if i < len(ch) - 1:
                self.add_module(f'up_{i}_us', Upsample(c, **kw))
                self.up_names.append(f'up_{i}_us')
        self.conv_norm_out = GroupNorm32(ch[-1], device)
        self.conv_out = _conv(ch[-1], 3, 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run(self.conv_in, z)
        h = self.mid_res_2(self.mid_attn(self.mid_res_1(h)))
        for name in self.up_names:
            h = getattr(self, name)(h)
        return _run(self.conv_out, F.silu(self.conv_norm_out(h)))


class PretrainedVAE(nn.Module):
    """AutoencoderKL decode with diffusers scaling semantics:
    z = z' / scaling_factor + shift_factor (the FLUX VAE's constants),
    then the decoder."""

    scaling_factor = 0.3611
    shift_factor = 0.1159

    def __init__(self, latent_channels: int = 16,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 device=None, dtype=None):
        super().__init__()
        self.decoder = Decoder(latent_channels, block_out_channels,
                               device=device, dtype=dtype)

    def _denormalize(self, z: torch.Tensor) -> torch.Tensor:
        return z / self.scaling_factor + self.shift_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Normalized latents (B, h, w, C) -> images (B, 8h, 8w, 3) in
        [-1, 1], fp32."""
        z = self._denormalize(latents.float()).permute(0, 3, 1, 2)
        return self.decoder(z).float().permute(0, 2, 3, 1)
