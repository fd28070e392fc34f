"""ArcFlow mixture-of-momentum policy as a dataclass of fp32 tensors.

Counterpart of ``arcflow_tpu/diffusion/policies/arcflow.py:ArcFlowPolicy``.
The DiT emits K components: velocity-space ``means`` (B, K, *data),
``logweights`` (B, K, *bcast) normalized over K, and ``loggammas``
(B, K-1, *bcast), the exponential rates of components 1..K-1 (component 0
has rate 0). The velocity at noise level sigma, from source level
sigma_src, is

    u(sigma) = sum_k softmax(logweights)_k * m_k * exp(rate_k * (sigma_src - sigma)).

Transforms (``detach``, ``dropout``, ``temperature``) return new policies;
nothing is mutated.
"""

from __future__ import annotations

import dataclasses

import torch

from ...parallel.mesh import batch_draw


def _bshape(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a (B,)-vector for broadcasting against a rank-``ndim`` tensor."""
    if a.dim() == ndim:
        return a
    assert a.dim() == 1, f'expected (B,) got {tuple(a.shape)}'
    return a.reshape(a.shape[0], *((ndim - 1) * [1]))


@dataclasses.dataclass(frozen=True)
class ArcFlowPolicy:
    """One DiT forward's mixture output, frozen at (x_src, sigma_src)."""

    means_u: torch.Tensor      # (B, K, *data)
    logweights: torch.Tensor   # (B, K, *bcast)
    loggammas: torch.Tensor    # (B, K-1, *bcast)
    x_t_src: torch.Tensor      # (B, *data)
    sigma_t_src: torch.Tensor  # (B,)
    eps: float = 1e-4

    @classmethod
    def create(cls, denoising_output: dict, x_t_src: torch.Tensor,
               sigma_t_src, eps: float = 1e-4) -> 'ArcFlowPolicy':
        """Build from a DiT output dict {means, logweights, loggammas}."""
        k = denoising_output['means'].shape[1]
        k_gamma = denoising_output['loggammas'].shape[1]
        if k_gamma != k - 1:
            raise ValueError(
                f'loggammas must have K-1={k - 1} components (component 0 has '
                f'fixed rate 0), got {k_gamma}')
        f32 = torch.float32
        sigma = torch.as_tensor(sigma_t_src, dtype=f32,
                                device=x_t_src.device)
        return cls(
            means_u=denoising_output['means'].to(f32),
            logweights=denoising_output['logweights'].to(f32),
            loggammas=denoising_output['loggammas'].to(f32),
            x_t_src=x_t_src.to(f32),
            sigma_t_src=sigma.reshape(x_t_src.shape[0]),
            eps=eps)

    def weights(self) -> torch.Tensor:
        return torch.softmax(self.logweights, dim=1)

    def decay(self, dt_past) -> torch.Tensor:
        """exp(rate_k * dt_past) with component 0 fixed at 1; ``dt_past`` is
        (B,) or broadcastable to (B, 1, *data)."""
        dt = _bshape(torch.as_tensor(dt_past, dtype=torch.float32,
                                     device=self.x_t_src.device),
                     self.x_t_src.dim())[:, None]
        grow = torch.exp(self.loggammas * dt)
        return torch.cat([torch.ones_like(grow[:, :1]), grow], dim=1)

    def velocity(self, sigma_t) -> torch.Tensor:
        """Mixture velocity u at noise level ``sigma_t``."""
        sigma_t = torch.as_tensor(sigma_t, dtype=torch.float32,
                                  device=self.x_t_src.device)
        dt_past = self.sigma_t_src - sigma_t.reshape(self.sigma_t_src.shape)
        v_k = self.means_u * self.decay(dt_past) * self.weights()
        return v_k.sum(dim=1)

    def detach(self) -> 'ArcFlowPolicy':
        """The same policy cut from the autograd graph (JAX
        ``stop_gradient`` over the pytree)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).detach()
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def dropout(self, generator: torch.Generator, p: float
                ) -> 'ArcFlowPolicy':
        """Drop mixture components at random, never all of a cell's, by a
        -inf logweight (JAX ``dropout``); one uniform draw per (sample,
        component) from ``generator``."""
        if p <= 0.0 or p >= 1.0:
            return self
        b, k = self.logweights.shape[:2]
        mask_shape = (b, k) + (1,) * (self.logweights.dim() - 2)
        drop = batch_draw(torch.rand, mask_shape, generator=generator,
                          device=self.logweights.device) < p
        drop = drop & ~drop.all(dim=1, keepdim=True)
        return dataclasses.replace(
            self, logweights=self.logweights.masked_fill(drop, -torch.inf))

    def temperature(self, temp: float) -> 'ArcFlowPolicy':
        """Sharpen or soften the mixture weights: logweights / temp."""
        if temp == 1.0:
            return self
        return dataclasses.replace(
            self, logweights=self.logweights / max(temp, self.eps))
