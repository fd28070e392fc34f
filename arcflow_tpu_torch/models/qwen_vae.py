"""Qwen-Image VAE decoder (the Wan 2.1 VAE in image mode).

Counterpart of ``arcflow_tpu/models/qwen_vae.py`` (``WanRMSNorm``,
``WanResidualBlock``, ``WanAttentionBlock``, ``WanMidBlock``,
``WanUpsample``, ``QwenVAEUpBlock``, ``QwenVAEDecoder`` and
``PretrainedVAEQwenImage.decode``). On a single frame the Wan 3-D causal
VAE reduces exactly to a 2-D network with temporally sliced kernels, which
is what the JAX package holds and what is ported. The public layout is the
JAX package's, channel last: ``decode`` takes (B, h, w, z) latents and
returns (B, 8h, 8w, 3) images; inside, the convs run NCHW. The mid-block
attention is plain torch (XLA in the JAX package, no kernel). The encoder
and the quant conv wait for their slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .vae import _conv, _run


class WanRMSNorm(nn.Module):
    """Channel RMS norm x / (||x||_c + 1e-12) * sqrt(c) * gamma in fp32
    (the eps is added after the square root, as in the JAX package);
    returns the input's dtype."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim, device=device,
                                             dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf.square().sum(dim=1, keepdim=True).sqrt() + 1e-12
        return (xf / norm * self.scale
                * self.gamma[None, :, None, None]).to(x.dtype)


class WanResidualBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, device=None, dtype=None):
        super().__init__()
        self.norm1 = WanRMSNorm(in_dim, device)
        self.conv1 = _conv(in_dim, out_dim, 3, device, dtype)
        self.norm2 = WanRMSNorm(out_dim, device)
        self.conv2 = _conv(out_dim, out_dim, 3, device, dtype)
        self.conv_shortcut = _conv(in_dim, out_dim, 1, device, dtype) \
            if in_dim != out_dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _run(self.conv1, F.silu(self.norm1(x)))
        h = _run(self.conv2, F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = _run(self.conv_shortcut, x)
        return x + h


class WanAttentionBlock(nn.Module):
    """Single-head self-attention over spatial positions with a fused qkv
    1x1 conv: plain matmuls and an fp32 softmax, no kernel."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.norm = WanRMSNorm(dim, device)
        self.to_qkv = _conv(dim, 3 * dim, 1, device, dtype)
        self.proj = _conv(dim, dim, 1, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        qkv = _run(self.to_qkv, self.norm(x)).flatten(2).transpose(1, 2)
        q, k, v = qkv.chunk(3, dim=-1)                       # (B, HW, C)
        logits = torch.matmul(q, k.transpose(1, 2)).float() / math.sqrt(c)
        attn = torch.matmul(logits.softmax(dim=-1).to(v.dtype), v)
        return x + _run(self.proj, attn.transpose(1, 2).reshape(b, c, h, w))


class WanMidBlock(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets_0 = WanResidualBlock(dim, dim, **kw)
        self.attentions_0 = WanAttentionBlock(dim, **kw)
        self.resnets_1 = WanResidualBlock(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets_1(self.attentions_0(self.resnets_0(x)))


class WanUpsample(nn.Module):
    """Nearest 2x, then a 3x3 conv to dim // 2 (Wan's upsample halves the
    width)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.resample_conv = _conv(dim, dim // 2, 3, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run(self.resample_conv,
                    F.interpolate(x, scale_factor=2.0, mode='nearest'))


class QwenVAEUpBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_resnets: int,
                 upsample: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_resnets = num_resnets
        for j in range(num_resnets):
            self.add_module(f'resnets_{j}', WanResidualBlock(
                in_dim if j == 0 else out_dim, out_dim, **kw))
        self.upsampler = WanUpsample(out_dim, **kw) if upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.num_resnets):
            x = getattr(self, f'resnets_{j}')(x)
        return self.upsampler(x) if self.upsampler is not None else x


class QwenVAEDecoder(nn.Module):
    """Latents (B, z, h, w) -> RGB (B, 3, 8h, 8w) for dim_mult (1, 2, 4, 4):
    widths base * [mult[-1], *reversed(mult)], num_res_blocks + 1 resnets
    per up block, each upsample halving the width it passes on."""

    def __init__(self, base_dim: int = 96, z_dim: int = 16,
                 dim_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_channels: int = 3,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        mult = tuple(dim_mult)
        dims = [base_dim * u for u in (mult[-1],) + mult[::-1]]
        self.conv_in = _conv(z_dim, dims[0], 3, **kw)
        self.mid_block = WanMidBlock(dims[0], **kw)
        self.num_up = len(dims) - 1
        prev = dims[0]
        for i, out_dim in enumerate(dims[1:]):
            upsample = i != len(mult) - 1
            self.add_module(f'up_blocks_{i}', QwenVAEUpBlock(
                prev, out_dim, num_res_blocks + 1, upsample, **kw))
            prev = out_dim // 2 if upsample else out_dim
        self.norm_out = WanRMSNorm(prev, device)
        self.conv_out = _conv(prev, out_channels, 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(_run(self.conv_in, z))
        for i in range(self.num_up):
            h = getattr(self, f'up_blocks_{i}')(h)
        return _run(self.conv_out, F.silu(self.norm_out(h)))


class PretrainedVAEQwenImage(nn.Module):
    """Qwen-Image VAE decode: per-channel latent denormalization
    z * latents_std + latents_mean, the post-quant 1x1 conv, then the
    decoder."""

    def __init__(self, base_dim: int = 96, z_dim: int = 16,
                 dim_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_channels: int = 3,
                 latents_mean: Optional[Sequence[float]] = None,
                 latents_std: Optional[Sequence[float]] = None,
                 device=None, dtype=None):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        mean = torch.zeros(z_dim, **f32) if latents_mean is None \
            else torch.tensor(latents_mean, **f32)
        std = torch.ones(z_dim, **f32) if latents_std is None \
            else torch.tensor(latents_std, **f32)
        # constants of the checkpoint's config, not weights
        self.register_buffer('latents_mean', mean, persistent=False)
        self.register_buffer('latents_std', std, persistent=False)
        self.decoder = QwenVAEDecoder(base_dim, z_dim, dim_mult,
                                      num_res_blocks, out_channels,
                                      device=device, dtype=dtype)
        self.post_quant_conv = _conv(z_dim, z_dim, 1, device, dtype)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Normalized latents (B, h, w, z) -> images (B, 8h, 8w, 3) in
        [-1, 1], fp32."""
        z = latents.float() * self.latents_std + self.latents_mean
        z = _run(self.post_quant_conv, z.permute(0, 3, 1, 2))
        return self.decoder(z).float().permute(0, 2, 3, 1)
