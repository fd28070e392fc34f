"""Small MLP denoisers for 2-D toy data.

Counterpart of ``arcflow_tpu/models/toy.py`` for the GMFlow family:
``timestep_embedding``, ``ToyGMFlowDenoiser`` and ``SpectrumMLP``. Module
and parameter names are the flax ones (``Dense_0``..., ``out_means``,
``out_logweights``, ``logstd``), so ``pipelines/convert.py:
jax_params_to_torch`` carries a flax tree over with ``strict=True``. Flax
infers input widths at init; here they follow from the constructor's
``hw`` (the data's H, W) and channel counts. Initialisation follows flax's
defaults: LeCun-normal kernels (truncated at two standard deviations), zero
biases, zero kernels where the JAX module says so, logstd -1.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import lecun_normal_


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


def _dense(n_in: int, n_out: int, zero_kernel: bool = False,
           device=None) -> nn.Linear:
    """fp32 Linear with flax's default init (or a zero kernel)."""
    lin = nn.Linear(n_in, n_out, device=device)
    with torch.no_grad():
        lin.bias.zero_()
        if zero_kernel:
            lin.weight.zero_()
        else:
            lecun_normal_(lin.weight)
    return lin


class ToyGMFlowDenoiser(nn.Module):
    """MLP emitting a GMFlow velocity mixture for (B, H, W, C) data: means
    (B, K, H, W, C), logstds (B, 1, 1, 1, 1) (one learned scalar) and
    logweights (B, K, H, W, 1)."""

    def __init__(self, out_channels: int = 2, num_gaussians: int = 8,
                 hidden: Sequence[int] = (256, 256, 256),
                 time_embed_dim: int = 64, num_timesteps: int = 1000,
                 hw: Tuple[int, int] = (1, 1), device=None):
        super().__init__()
        self.out_channels, self.num_gaussians = out_channels, num_gaussians
        self.time_embed_dim, self.num_timesteps = time_embed_dim, num_timesteps
        self.hw = tuple(hw)
        n_pix = self.hw[0] * self.hw[1]
        width = n_pix * out_channels + time_embed_dim
        self.n_hidden = len(hidden)
        for i, w in enumerate(hidden):
            setattr(self, f'Dense_{i}', _dense(width, w, device=device))
            width = w
        self.out_means = _dense(width, num_gaussians * n_pix * out_channels,
                                device=device)
        self.out_logweights = _dense(width, num_gaussians * n_pix,
                                     zero_kernel=True, device=device)
        self.logstd = nn.Parameter(torch.full((1,), -1.0, device=device))

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


class SpectrumMLP(nn.Module):
    """Log power spectrum (B, height, width, C) from iso-Gaussian x0
    statistics, mean (B, H, W, C) and var (B, H, W, 1)."""

    def __init__(self, height: int = 1, width: int = 1, hidden: int = 128,
                 channels: int = 2, device=None):
        super().__init__()
        self.height, self.width, self.channels = height, width, channels
        n_pix = height * width
        self.Dense_0 = _dense(n_pix * (channels + 1), hidden, device=device)
        self.Dense_1 = _dense(hidden, n_pix * channels, zero_kernel=True,
                              device=device)

    def forward(self, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        b = mean.shape[0]
        feat = torch.cat([mean.reshape(b, -1), var.reshape(b, -1)], dim=-1)
        out = self.Dense_1(F.silu(self.Dense_0(feat)))
        return out.reshape(b, self.height, self.width, self.channels)
