"""AutoencoderKL (SD/FLUX-style VAE) and its latent (de)normalization.

Counterpart of ``arcflow_tpu/models/vae.py`` (``ResnetBlock``, ``AttnBlock``,
``Downsample``, ``Upsample``, ``Encoder``, ``Decoder`` and
``PretrainedVAE._normalize``/``encode``/``_denormalize``/``decode``).
The public layout is the JAX package's, channel last: ``encode`` takes
(B, H, W, 3) images and returns (B, H/8, W/8, C) latents, ``decode`` the
reverse; inside, the convs run NCHW. GroupNorms compute in fp32, as in the
JAX package. Convs and linears are drawn as flax's ``nn.Conv``/``nn.Dense``
defaults draw them (truncated LeCun normal, zero bias: ``flax_init_``).
``from_pretrained`` loads a diffusers AutoencoderKL folder
(``pipelines/convert.py:diffusers_vae_to_torch``), the halves the module
has. The JAX wrapper always holds both halves; the port builds the encoder
(and ``quant_conv``) only when asked (``with_encoder``), so a serving
pipeline keeps the decoder alone.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import MODULES
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


class Downsample(nn.Module):
    """Zero pad (0, 1, 0, 1), then a 3x3 conv of stride 2 (diffusers'
    ``Downsample2D``)."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.conv = flax_init_(nn.Conv2d(channels, channels, 3, stride=2,
                                         device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run(self.conv, F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.conv = _conv(channels, channels, 3, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run(self.conv, F.interpolate(x, scale_factor=2.0,
                                             mode='nearest'))


class Encoder(nn.Module):
    """RGB images (B, 3, H, W) -> moments (B, 2 C, H/8, W/8) = [mean,
    logvar]: layers_per_block resnets per level and a 2x downsample
    between levels, the mid block, then GroupNorm, SiLU and the out conv."""

    def __init__(self, latent_channels: int = 16,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch = list(block_out_channels)
        self.conv_in = _conv(3, ch[0], 3, **kw)
        self.down_names = []
        prev = ch[0]
        for i, c in enumerate(ch):
            for j in range(layers_per_block):
                self.add_module(f'down_{i}_res_{j}',
                                ResnetBlock(prev, c, **kw))
                self.down_names.append(f'down_{i}_res_{j}')
                prev = c
            if i < len(ch) - 1:
                self.add_module(f'down_{i}_ds', Downsample(c, **kw))
                self.down_names.append(f'down_{i}_ds')
        self.mid_res_1 = ResnetBlock(ch[-1], ch[-1], **kw)
        self.mid_attn = AttnBlock(ch[-1], **kw)
        self.mid_res_2 = ResnetBlock(ch[-1], ch[-1], **kw)
        self.conv_norm_out = GroupNorm32(ch[-1], device)
        self.conv_out = _conv(ch[-1], 2 * latent_channels, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _run(self.conv_in, x)
        for name in self.down_names:
            h = getattr(self, name)(h)
        h = self.mid_res_2(self.mid_attn(self.mid_res_1(h)))
        return _run(self.conv_out, F.silu(self.conv_norm_out(h)))


def posterior(moments: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """The latent of (B, 2C, h, w) moments [mean, logvar]: a draw
    mean + exp(logvar / 2, logvar clipped to [-30, 20]) eps with eps from
    ``generator``, or the mean without one (JAX ``encode`` with and without
    ``rng``); fp32."""
    mean, logvar = moments.chunk(2, dim=1)
    if generator is None:
        return mean.float()
    eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                      dtype=mean.dtype)
    return (mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * eps).float()


class Decoder(nn.Module):
    """Latents (B, C, h, w) -> RGB images (B, 3, H, W), upsampled 2x between
    levels (8x for FLUX's four); layers_per_block + 1 resnets per level
    (three for FLUX)."""

    def __init__(self, latent_channels: int = 16,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, device=None, dtype=None):
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
            for j in range(layers_per_block + 1):
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


def torch_dtype(dtype):
    """A torch dtype, or a config's name of one ('bfloat16'); None stays."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def load_vae_folder(module: nn.Module, path: str, convert,
                    what: str = 'vae') -> None:
    """Load a diffusers VAE folder into ``module`` (its ``state_dict``
    keys, cast to their dtypes): the top-level parts the module lacks (the
    encoder, quant convs it was built without) are dropped as in JAX; any
    other missing or unexpected key raises the JAX error."""
    from ..pipelines.convert import graft_pretrained, load_safetensors_state
    converted, _ = convert(load_safetensors_state(path),
                           encoder=getattr(module, 'encoder', None)
                           is not None)
    own = module.state_dict()
    tops = {k.partition('.')[0] for k in own}
    converted = {k: v for k, v in converted.items()
                 if k.partition('.')[0] in tops}
    state, missing, unexpected = graft_pretrained(own, converted)
    if missing or unexpected:
        raise ValueError(f'{what} load mismatch: missing {missing[:3]}, '
                         f'unexpected {unexpected[:3]}')
    module.load_state_dict(state, strict=True)


@MODULES.register_module()
class PretrainedVAE(nn.Module):
    """AutoencoderKL with diffusers scaling semantics (JAX
    ``PretrainedVAE``). ``decode``: z = z' / scaling_factor + shift_factor
    (the FLUX VAE's constants), or the per-channel ``latents_mean`` /
    ``latents_std`` when given, the 1x1 ``post_quant_conv`` of SD-family
    VAEs (``use_post_quant_conv``), then the decoder. ``encode`` (with
    ``with_encoder``): the encoder, the 1x1 ``quant_conv``
    (``use_quant_conv``), the posterior's mean or a draw, then the inverse
    normalization. ``from_pretrained`` (+ ``subfolder``) loads a diffusers
    folder's weights; the folder's ``config.json`` fields come in as
    constructor arguments (``ArcFluxPipeline._load_vae_folder``). Other
    options of the JAX wrapper are taken and ignored."""

    def __init__(self, latent_channels: int = 16,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, scaling_factor: float = 0.3611,
                 shift_factor: float = 0.1159,
                 latents_mean: Optional[Sequence[float]] = None,
                 latents_std: Optional[Sequence[float]] = None,
                 use_quant_conv: bool = False,
                 use_post_quant_conv: bool = False,
                 with_encoder: bool = False, with_decoder: bool = True,
                 from_pretrained: Optional[str] = None, subfolder: str = '',
                 device=None, dtype=None, **kwargs):
        super().__init__()
        dtype = torch_dtype(dtype)
        self.scaling_factor = scaling_factor
        self.shift_factor = shift_factor
        f32 = dict(device=device, dtype=torch.float32)
        self.latents_mean = None if latents_mean is None \
            else torch.tensor(latents_mean, **f32)
        self.latents_std = None if latents_std is None \
            else torch.tensor(latents_std, **f32)
        self.encoder = Encoder(latent_channels, block_out_channels,
                               layers_per_block, device=device, dtype=dtype) \
            if with_encoder else None
        self.quant_conv = _conv(2 * latent_channels, 2 * latent_channels, 1,
                                device, dtype) \
            if with_encoder and use_quant_conv else None
        self.decoder = Decoder(latent_channels, block_out_channels,
                               layers_per_block, device=device, dtype=dtype) \
            if with_decoder else None
        self.post_quant_conv = _conv(latent_channels, latent_channels, 1,
                                     device, dtype) \
            if with_decoder and use_post_quant_conv else None
        if from_pretrained is not None:
            from ..pipelines.convert import diffusers_vae_to_torch
            load_vae_folder(self, os.path.join(from_pretrained, subfolder),
                            diffusers_vae_to_torch)

    def _normalize(self, z: torch.Tensor) -> torch.Tensor:
        if self.latents_mean is not None:
            return (z - self.latents_mean.to(z.device)) \
                / self.latents_std.to(z.device)
        return (z - self.shift_factor) * self.scaling_factor

    def _denormalize(self, z: torch.Tensor) -> torch.Tensor:
        if self.latents_mean is not None:
            return z * self.latents_std.to(z.device) \
                + self.latents_mean.to(z.device)
        return z / self.scaling_factor + self.shift_factor

    def encode(self, images: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Images (B, H, W, 3) in [-1, 1] -> normalized latents
        (B, H/8, W/8, C), fp32: the posterior's mean, or a draw from
        ``generator`` when one is given."""
        if self.encoder is None:
            raise RuntimeError('decoder-only VAE')
        moments = self.encoder(images.permute(0, 3, 1, 2))
        if self.quant_conv is not None:
            moments = _run(self.quant_conv, moments)
        z = posterior(moments, generator).permute(0, 2, 3, 1)
        return self._normalize(z)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Normalized latents (B, h, w, C) -> images (B, 8h, 8w, 3) in
        [-1, 1], fp32."""
        if self.decoder is None:
            raise RuntimeError('encoder-only VAE')
        z = self._denormalize(latents.float()).permute(0, 3, 1, 2)
        if self.post_quant_conv is not None:
            z = _run(self.post_quant_conv, z)
        return self.decoder(z).float().permute(0, 2, 3, 1)


@MODULES.register_module()
class PretrainedVAEDecoder(PretrainedVAE):
    """The decoder-only VAE of the training configs (JAX
    ``PretrainedVAEDecoder``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **dict(kwargs, with_encoder=False,
                                       with_decoder=True))


@MODULES.register_module()
class PretrainedVAEEncoder(PretrainedVAE):
    """The encoder-only VAE of latent cachers (JAX
    ``PretrainedVAEEncoder``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **dict(kwargs, with_encoder=True,
                                       with_decoder=False))
