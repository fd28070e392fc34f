"""ADM-style class-conditional denoising UNet and its ArcFlow student.

Counterpart of ``arcflow_tpu/models/unet.py`` (``UNetResBlock``,
``UNetAttnBlock``, ``DenoisingUnetMod``, ``ArcDenoisingUnetMod``,
``ARCUNET_ADAPTER_KEYS``), under the JAX module's parameter names
(``down_1_0.conv1.weight``, ``mid_attn.qkv.weight``, ``class_embed.weight``)
so ``pipelines/convert.py:jax_params_to_torch`` carries a flax tree over.

Latents are channel-last (B, H, W, C) in and out, as in JAX, since the
policy, the integrator and the dataset use that layout; inside, the convs
run NCHW. flax infers input widths and the attention placement from the
first call; a torch module must know them when it is built, so the UNet
takes ``data_shape`` (H, W, C) of its latents (the composition passes its
``latent_shape``; 32 x 32 without one) and refuses another resolution.

The attention is a stock op, ``F.scaled_dot_product_attention`` in fp32:
the JAX module computes it with XLA's ``jax.nn.dot_product_attention``, not
with a Pallas kernel, at head dims 32 and 64 in fp32, which none of the
port's hand-written kernels (bf16, head dim 128) covers.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..registry import MODULES
from .toy import _dense, timestep_embedding
from .vae import GroupNorm32, flax_init_


def _conv(n_in: int, n_out: int, k: int = 3, stride: int = 1,
          zero_kernel: bool = False, device=None) -> nn.Conv2d:
    """flax ``nn.Conv`` (padding k // 2) with its default init, or a zero
    kernel."""
    conv = flax_init_(nn.Conv2d(n_in, n_out, k, stride=stride,
                                padding=k // 2, device=device))
    if zero_kernel:
        with torch.no_grad():
            conv.weight.zero_()
    return conv


class UNetResBlock(nn.Module):
    """GroupNorm -> SiLU -> 3x3 conv, ADM scale-shift from the embedding,
    GroupNorm -> SiLU -> zero-initialised 3x3 conv, plus the input (through
    a 1x1 ``skip`` when the width changes)."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 device=None):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, device)
        self.conv1 = _conv(in_channels, out_channels, device=device)
        self.emb_proj = _dense(emb_dim, 2 * out_channels, device=device)
        self.norm2 = GroupNorm32(out_channels, device)
        self.conv2 = _conv(out_channels, out_channels, zero_kernel=True,
                           device=device)
        self.skip = _conv(in_channels, out_channels, k=1, device=device) \
            if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        scale, shift = self.emb_proj(F.silu(emb))[:, :, None, None].chunk(
            2, dim=1)
        h = self.conv2(F.silu(self.norm2(h) * (1 + scale) + shift))
        return (x if self.skip is None else self.skip(x)) + h


class UNetAttnBlock(nn.Module):
    """Multi-head self-attention over the H x W positions, residual. The
    ``qkv`` Dense's output columns are [q | k | v] per head (JAX reshapes
    to (B, HW, heads, 3 head_dim) before it splits)."""

    def __init__(self, channels: int, num_heads: int = 8, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels, device)
        self.qkv = _dense(channels, 3 * channels, device=device)
        self.proj = _dense(channels, channels, zero_kernel=True,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.norm(x).reshape(b, c, hh * ww).transpose(1, 2)
        qkv = self.qkv(h).reshape(b, hh * ww, self.num_heads,
                                  3 * (c // self.num_heads))
        q, k, v = qkv.transpose(1, 2).chunk(3, dim=-1)
        out = F.scaled_dot_product_attention(q, k, v)
        out = self.proj(out.transpose(1, 2).reshape(b, hh * ww, c))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


@MODULES.register_module()
class DenoisingUnetMod(nn.Module):
    """Class-conditional UNet u-predictor on (B, H, W, C) latents. Label
    ``num_classes`` is the null (CFG-negative) class: the class embedding
    has ``num_classes + 1`` rows."""

    def __init__(self, in_channels: int = 4, base_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16, 8),
                 num_classes: Optional[int] = 1000, num_heads: int = 8,
                 num_timesteps: int = 1000, data_shape=None, device=None):
        super().__init__()
        self.in_channels, self.base_channels = in_channels, base_channels
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.num_classes, self.num_timesteps = num_classes, num_timesteps
        self.resolution = int(data_shape[0]) if data_shape else 32
        emb_dim = base_channels * 4
        self.time_mlp1 = _dense(base_channels, emb_dim, device=device)
        self.time_mlp2 = _dense(emb_dim, emb_dim, device=device)
        if num_classes is not None:
            self.class_embed = nn.Embedding(num_classes + 1, emb_dim,
                                            device=device)
            with torch.no_grad():   # flax Embed's init: N(0, 1 / features)
                self.class_embed.weight.normal_(std=1 / math.sqrt(emb_dim))

        self.conv_in = _conv(in_channels, base_channels, device=device)
        ch_in, skip_chs, res = base_channels, [base_channels], self.resolution
        for level, mult in enumerate(self.channel_mult):
            ch = base_channels * mult
            for j in range(num_res_blocks):
                setattr(self, f'down_{level}_{j}',
                        UNetResBlock(ch_in, ch, emb_dim, device=device))
                ch_in = ch
                if res in self.attn_resolutions:
                    setattr(self, f'down_attn_{level}_{j}',
                            UNetAttnBlock(ch, num_heads, device=device))
                skip_chs.append(ch)
            if level < len(self.channel_mult) - 1:
                setattr(self, f'down_{level}_ds',
                        _conv(ch, ch, stride=2, device=device))
                skip_chs.append(ch)
                res //= 2

        self.mid_1 = UNetResBlock(ch_in, ch_in, emb_dim, device=device)
        self.mid_attn = UNetAttnBlock(ch_in, num_heads, device=device)
        self.mid_2 = UNetResBlock(ch_in, ch_in, emb_dim, device=device)

        for level, mult in reversed(list(enumerate(self.channel_mult))):
            ch = base_channels * mult
            for j in range(num_res_blocks + 1):
                setattr(self, f'up_{level}_{j}',
                        UNetResBlock(ch_in + skip_chs.pop(), ch, emb_dim,
                                     device=device))
                ch_in = ch
                if res in self.attn_resolutions:
                    setattr(self, f'up_attn_{level}_{j}',
                            UNetAttnBlock(ch, num_heads, device=device))
            if level > 0:
                setattr(self, f'up_{level}_us', _conv(ch, ch, device=device))
                res *= 2
        self.norm_out = GroupNorm32(ch_in, device)
        self._build_head(ch_in, device)

    def _build_head(self, width: int, device):
        self.conv_out = _conv(width, self.in_channels, zero_kernel=True,
                              device=device)

    def _trunk(self, x_t: torch.Tensor, t: torch.Tensor,
               label: Optional[torch.Tensor]) -> torch.Tensor:
        """The shared body up to the output head: silu(norm_out(h)), NCHW,
        in fp32."""
        if x_t.shape[1] != self.resolution:
            raise ValueError(f'latents {tuple(x_t.shape)}: this UNet was '
                             f'built for {self.resolution} x '
                             f'{self.resolution} (its attention placement '
                             f'depends on the resolution)')
        t = torch.as_tensor(t, dtype=torch.float32, device=x_t.device)
        t = t.expand(x_t.shape[0]) if t.dim() == 0 else t
        temb = timestep_embedding(t / self.num_timesteps * 1000.0,
                                  self.base_channels)
        emb = self.time_mlp2(F.silu(self.time_mlp1(temb)))
        if self.num_classes is not None:
            if label is None:
                raise ValueError('a class-conditional UNet needs labels')
            emb = emb + self.class_embed(label.long())

        h = self.conv_in(x_t.permute(0, 3, 1, 2).float())
        skips, res = [h], self.resolution
        levels = len(self.channel_mult)
        for level in range(levels):
            for j in range(self.num_res_blocks):
                h = getattr(self, f'down_{level}_{j}')(h, emb)
                if res in self.attn_resolutions:
                    h = getattr(self, f'down_attn_{level}_{j}')(h)
                skips.append(h)
            if level < levels - 1:
                h = getattr(self, f'down_{level}_ds')(h)
                skips.append(h)
                res //= 2

        h = self.mid_2(self.mid_attn(self.mid_1(h, emb)), emb)

        for level in reversed(range(levels)):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f'up_{level}_{j}')(
                    torch.cat([h, skips.pop()], dim=1), emb)
                if res in self.attn_resolutions:
                    h = getattr(self, f'up_attn_{level}_{j}')(h)
            if level > 0:
                # nearest at exactly 2x: jax.image.resize's 'nearest'
                h = getattr(self, f'up_{level}_us')(
                    F.interpolate(h, scale_factor=2, mode='nearest'))
                res *= 2
        return F.silu(self.norm_out(h))

    def forward(self, x_t: torch.Tensor, t: torch.Tensor,
                label: Optional[torch.Tensor] = None,
                **kwargs) -> torch.Tensor:
        return self.conv_out(self._trunk(x_t, t, label)).permute(0, 2, 3, 1)


@MODULES.register_module()
class ArcDenoisingUnetMod(DenoisingUnetMod):
    """ArcFlow student UNet: the same trunk and three mixture heads (the
    UNet analogue of the ArcFlux heads, in fp32). Output dict: means
    (B, K, H, W, C), logweights (B, K, H, W, 1) log-softmaxed over K,
    loggammas (B, K - 1, H, W, 1). The means head's channels are k * C + c
    (c fastest); its bias is 0.1 N(0, 1) from torch's generator, the
    loggamma bias log(logspace(0.2, 4.0, K - 1))."""

    def __init__(self, *args, num_gaussians: int = 8, **kwargs):
        self.num_gaussians = num_gaussians
        super().__init__(*args, **kwargs)

    def _build_head(self, width: int, device):
        k, c = self.num_gaussians, self.in_channels
        self.proj_out_means = _conv(width, k * c, zero_kernel=True,
                                    device=device)
        self.proj_out_logweights = _conv(width, k, zero_kernel=True,
                                         device=device)
        self.proj_out_loggamma = _conv(width, k - 1, zero_kernel=True,
                                       device=device)
        with torch.no_grad():
            self.proj_out_means.bias.normal_().mul_(0.1)
            rates = np.logspace(math.log10(0.2), math.log10(4.0), k - 1)
            self.proj_out_loggamma.bias.copy_(torch.from_numpy(
                np.log(rates)))

    def forward(self, x_t: torch.Tensor, t: torch.Tensor,
                label: Optional[torch.Tensor] = None, **kwargs) -> dict:
        b, hh, ww, c = x_t.shape
        k = self.num_gaussians
        h = self._trunk(x_t, t, label)
        means = self.proj_out_means(h).reshape(b, k, c, hh, ww)
        logweights = torch.log_softmax(self.proj_out_logweights(h), dim=1)
        loggammas = self.proj_out_loggamma(h)
        return dict(means=means.permute(0, 1, 3, 4, 2),
                    logweights=logweights[..., None],
                    loggammas=loggammas[..., None])


# the Arc UNet student's trainable surface when only its heads train (the
# trunk the teacher's, frozen), as ARCFLUX_ADAPTER_KEYS
ARCUNET_ADAPTER_KEYS = ('proj_out_means', 'proj_out_logweights',
                        'proj_out_loggamma')
