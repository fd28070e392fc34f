"""Small MLP denoisers for 2-D toy data.

Counterpart of ``arcflow_tpu/models/toy.py``: ``timestep_embedding``,
``fourier_features``, ``ToyMLPDenoiser`` (a u predictor),
``ToyGMFlowDenoiser``, ``SpectrumMLP`` and ``ToyArcFlowDenoiser`` (the
ArcFlux head contract), registered in ``MODULES`` under the JAX names.
Module and parameter names are the flax ones (``LoRADense_0``...,
``Dense_0``..., ``out_means``, ``proj_out_means``, ``logstd``), so
``pipelines/convert.py:jax_params_to_torch`` carries a flax tree over with
``strict=True``. The MLP trunks of ``ToyMLPDenoiser`` and
``ToyArcFlowDenoiser`` are the port's ``LoRADense`` at rank 0, as in JAX, so
``utils/quantize.py`` quantizes a toy teacher as it does the FLUX trunk.
Flax infers input widths at init; here they follow from ``data_shape``
(the shape of one sample, which the compositions pass) and the channel
counts. Initialisation follows flax's defaults: LeCun-normal kernels
(truncated at two standard deviations), zero biases, zero kernels where the
JAX module says so, logstd -1, the ArcFlow means bias 0.1 N(0, 1) and the
loggamma bias log-spaced rates in [0.2, 4]. Parameters are made in
``dtype`` (fp32, as the JAX toys) on ``device``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..registry import MODULES
from .layers import LoRADense, lecun_normal_


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of (B,) timesteps -> (B, dim), [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def fourier_features(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF-style features of raw coordinates (B, C) -> (B, C * 2 n_freqs),
    [sin, cos] of x * 2^i pi per coordinate; empty for n_freqs = 0. Plain
    MLPs underfit the checkerboard's cells (spectral bias); these resolve
    them."""
    if n_freqs <= 0:
        return x.new_zeros((*x.shape[:-1], 0))
    freqs = (2.0 ** torch.arange(n_freqs, dtype=torch.float32,
                                 device=x.device)) * math.pi
    ang = x[..., None].float() * freqs
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return out.reshape(*x.shape[:-1], -1).to(x.dtype)


def _dense(n_in: int, n_out: int, zero_kernel: bool = False,
           device=None, dtype=torch.float32) -> nn.Linear:
    """Linear with flax's default init (or a zero kernel)."""
    lin = nn.Linear(n_in, n_out, device=device, dtype=dtype)
    with torch.no_grad():
        lin.bias.zero_()
        if zero_kernel:
            lin.weight.zero_()
        else:
            lecun_normal_(lin.weight)
    return lin


def _trunk_dense(n_in: int, n_out: int, device=None,
                 dtype=torch.float32) -> LoRADense:
    """The toy trunks' layer: a rank-0 ``LoRADense`` (a plain dense layer
    the quantizers know), as JAX ``toy.py:_trunk_dense``."""
    return LoRADense(n_in, n_out, device=device, dtype=dtype)


def _input_width(data_shape, out_channels: int, fourier_freqs: int,
                 time_embed_dim: int) -> int:
    """[x, fourier(x), temb] width for (B, C) data."""
    c = data_shape[-1] if data_shape else out_channels
    return c * (1 + 2 * fourier_freqs) + time_embed_dim


class _ToyMLPTrunk(nn.Module):
    """[x_t, fourier(x_t), temb] -> silu(LoRADense_i(...)) for each hidden
    width; subclasses add the heads."""

    def __init__(self, out_channels: int, hidden: Sequence[int],
                 time_embed_dim: int, num_timesteps: int, fourier_freqs: int,
                 data_shape, device, dtype):
        super().__init__()
        self.out_channels = out_channels
        self.time_embed_dim, self.num_timesteps = time_embed_dim, num_timesteps
        self.fourier_freqs = fourier_freqs
        width = _input_width(data_shape, out_channels, fourier_freqs,
                             time_embed_dim)
        self.n_hidden = len(hidden)
        for i, w in enumerate(hidden):
            setattr(self, f'LoRADense_{i}',
                    _trunk_dense(width, w, device=device, dtype=dtype))
            width = w
        self.width = width

    def trunk(self, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(t / self.num_timesteps * 1000.0,
                                  self.time_embed_dim)
        h = torch.cat([x_t, fourier_features(x_t, self.fourier_freqs),
                       temb.to(x_t.dtype)], dim=-1)
        for i in range(self.n_hidden):
            h = F.silu(getattr(self, f'LoRADense_{i}')(h))
        return h


@MODULES.register_module()
class ToyMLPDenoiser(_ToyMLPTrunk):
    """MLP u predictor for (B, C) data."""

    def __init__(self, out_channels: int = 2,
                 hidden: Sequence[int] = (256, 256, 256),
                 time_embed_dim: int = 64, num_timesteps: int = 1000,
                 fourier_freqs: int = 0, data_shape=None, device=None,
                 dtype=torch.float32):
        super().__init__(out_channels, hidden, time_embed_dim, num_timesteps,
                         fourier_freqs, data_shape, device, dtype)
        self.Dense_0 = _dense(self.width, out_channels, device=device,
                              dtype=dtype)

    def forward(self, x_t: torch.Tensor, t: torch.Tensor, **kwargs):
        return self.Dense_0(self.trunk(x_t, t))


@MODULES.register_module()
class ToyArcFlowDenoiser(_ToyMLPTrunk):
    """MLP emitting ArcFlow mixture parameters for (B, C) data, the ArcFlux
    head contract: means (B, K, C), logweights (B, K, 1) log-softmaxed over
    K, loggammas (B, K - 1, 1). ``moe_experts`` > 0 (a mid-trunk MoE) is
    not ported."""

    def __init__(self, out_channels: int = 2, num_gaussians: int = 8,
                 hidden: Sequence[int] = (256, 256, 256),
                 time_embed_dim: int = 64, num_timesteps: int = 1000,
                 fourier_freqs: int = 0, moe_experts: int = 0,
                 moe_capacity_factor: float = 2.0, data_shape=None,
                 device=None, dtype=torch.float32):
        if moe_experts > 0:
            raise NotImplementedError(
                'ToyArcFlowDenoiser(moe_experts > 0) needs MoEFeedForward, '
                'which the port does not have yet (ROADMAP.md queue A '
                'item 5)')
        super().__init__(out_channels, hidden, time_embed_dim, num_timesteps,
                         fourier_freqs, data_shape, device, dtype)
        k, c, w = num_gaussians, out_channels, self.width
        self.num_gaussians = k
        kw = dict(zero_kernel=True, device=device, dtype=dtype)
        self.proj_out_means = _dense(w, k * c, **kw)
        self.proj_out_logweights = _dense(w, k, **kw)
        self.proj_out_loggamma = _dense(w, k - 1, **kw)
        with torch.no_grad():
            self.proj_out_means.bias.normal_().mul_(0.1)
            rates = np.logspace(math.log10(0.2), math.log10(4.0), k - 1)
            self.proj_out_loggamma.bias.copy_(torch.from_numpy(
                np.log(rates)).to(dtype))

    def forward(self, x_t: torch.Tensor, t: torch.Tensor, **kwargs) -> dict:
        k, c = self.num_gaussians, self.out_channels
        h = self.trunk(x_t, t)
        means = self.proj_out_means(h).reshape(-1, k, c)
        logweights = torch.log_softmax(
            self.proj_out_logweights(h).reshape(-1, k, 1), dim=1)
        loggammas = self.proj_out_loggamma(h).reshape(-1, k - 1, 1)
        return dict(means=means, logweights=logweights, loggammas=loggammas)


@MODULES.register_module()
class ToyGMFlowDenoiser(nn.Module):
    """MLP emitting a GMFlow velocity mixture for (B, H, W, C) data: means
    (B, K, H, W, C), logstds (B, 1, 1, 1, 1) (one learned scalar) and
    logweights (B, K, H, W, 1). The data's H, W come as ``hw`` or as the
    first two axes of ``data_shape``."""

    def __init__(self, out_channels: int = 2, num_gaussians: int = 8,
                 hidden: Sequence[int] = (256, 256, 256),
                 time_embed_dim: int = 64, num_timesteps: int = 1000,
                 hw: Optional[Tuple[int, int]] = None, data_shape=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.out_channels, self.num_gaussians = out_channels, num_gaussians
        self.time_embed_dim, self.num_timesteps = time_embed_dim, num_timesteps
        self.hw = tuple(hw or (data_shape or (1, 1))[:2])
        n_pix = self.hw[0] * self.hw[1]
        width = n_pix * out_channels + time_embed_dim
        kw = dict(device=device, dtype=dtype)
        self.n_hidden = len(hidden)
        for i, w in enumerate(hidden):
            setattr(self, f'Dense_{i}', _dense(width, w, **kw))
            width = w
        self.out_means = _dense(width, num_gaussians * n_pix * out_channels,
                                **kw)
        self.out_logweights = _dense(width, num_gaussians * n_pix,
                                     zero_kernel=True, **kw)
        self.logstd = nn.Parameter(torch.full((1,), -1.0, **kw))

    def forward(self, x_t: torch.Tensor, t: torch.Tensor, **kwargs) -> dict:
        b = x_t.shape[0]
        k, c = self.num_gaussians, self.out_channels
        temb = timestep_embedding(t / self.num_timesteps * 1000.0,
                                  self.time_embed_dim)
        h = torch.cat([x_t.reshape(b, -1), temb], dim=-1)
        for i in range(self.n_hidden):
            h = F.silu(getattr(self, f'Dense_{i}')(h))
        means = self.out_means(h).reshape(b, k, *self.hw, c)
        logweights = torch.log_softmax(
            self.out_logweights(h).reshape(b, k, *self.hw, 1), dim=1)
        logstds = self.logstd.reshape(1, 1, 1, 1, 1).expand(b, 1, 1, 1, 1)
        return dict(means=means, logstds=logstds, logweights=logweights)


@MODULES.register_module()
class SpectrumMLP(nn.Module):
    """Log power spectrum (B, height, width, C) from iso-Gaussian x0
    statistics, mean (B, H, W, C) and var (B, H, W, 1)."""

    def __init__(self, height: int = 1, width: int = 1, hidden: int = 128,
                 channels: int = 2, device=None, dtype=torch.float32):
        super().__init__()
        self.height, self.width, self.channels = height, width, channels
        n_pix = height * width
        kw = dict(device=device, dtype=dtype)
        self.Dense_0 = _dense(n_pix * (channels + 1), hidden, **kw)
        self.Dense_1 = _dense(hidden, n_pix * channels, zero_kernel=True,
                              **kw)

    def forward(self, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        b = mean.shape[0]
        feat = torch.cat([mean.reshape(b, -1), var.reshape(b, -1)], dim=-1)
        out = self.Dense_1(F.silu(self.Dense_0(feat)))
        return out.reshape(b, self.height, self.width, self.channels)
