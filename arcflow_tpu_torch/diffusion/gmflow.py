"""GMFlow: Gaussian-mixture flow matching.

Counterpart of ``arcflow_tpu/diffusion/gmflow.py``. The denoiser outputs a
mixture over the velocity field ``{means (B,K,H,W,C), logstds, logweights
(B,K,H,W,1)}``. Training regresses the transition distribution
x_{t_low} | x_{t_high} (GM NLL), optionally with a spectral loss on
KR-whitened residuals; sampling runs GM-ODE/SDE steps with optional
probabilistic CFG, posterior-mean substeps and a 2nd-order mean correction.

The JAX module compiles its sampling steps into one ``lax.scan`` whose carry
holds the 2nd-order cache; here the steps are a Python loop and the cache
is the previous step's corrected mixture (none before the first step, where
the JAX module multiplies the correction by a zero ``valid`` flag). Every
draw comes from one ``torch.Generator``: the training times and noises in
the JAX module's order, and in sampling each draw (``output_mode='sample'``,
the SDE scheduler) is fresh, where the JAX module reuses one key for all
substeps of a step.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.gm import (gm_mul_iso_gaussian, gm_samples_to_gaussian_samples,
                      gm_to_iso_gaussian, gm_to_mean, gm_to_sample,
                      iso_gaussian_mul_iso_gaussian)
from ..registry import MODULES
from .gaussian_flow import GaussianFlow, _bview, denoiser_args

Tensor = torch.Tensor


def probabilistic_guidance(cond_mean: Tensor, total_var: Tensor,
                           uncond_mean: Tensor, guidance_scale: float,
                           orthogonal: float = 1.0,
                           orthogonal_axis: Optional[Tensor] = None):
    """Variance-calibrated CFG bias, guidance_scale in (0, 1): (gaussian
    {mean, var}, bias, avg_var)."""
    dims = tuple(range(1, cond_mean.dim()))
    bias = cond_mean - uncond_mean
    if orthogonal > 0.0:
        axis = cond_mean if orthogonal_axis is None else orthogonal_axis
        proj = (bias * axis).mean(dims, keepdim=True) / (
            axis * axis).mean(dims, keepdim=True).clamp_min(1e-6)
        bias = bias - proj * axis * orthogonal
    bias_power = bias.square().mean(dims, keepdim=True)
    avg_var = total_var.mean(dims, keepdim=True)
    bias = bias * (torch.sqrt(avg_var / bias_power.clamp_min(1e-6))
                   * guidance_scale)
    gaussian = dict(mean=cond_mean + bias,
                    var=total_var * (1 - guidance_scale ** 2))
    return gaussian, bias, avg_var


def gmflow_posterior(gm_x0: Dict[str, Tensor], x_t: Tensor, x_t_src: Tensor,
                     sigma_t: Tensor, sigma_t_src: Tensor, eps: float = 1e-6
                     ) -> Dict[str, Tensor]:
    """Bayes-fuse an x0-space GM with the bridge Gaussian implied by having
    observed both x_{t_src} and x_t; sigmas are (B,)."""
    nd = x_t.dim()
    s_src = _bview(sigma_t_src, nd)
    s_t = _bview(sigma_t, nd)
    a_src = 1 - s_src
    a_t = 1 - s_t
    denom = (a_t.square() * s_src.square()
             - a_src.square() * s_t.square()).clamp_min(eps)
    g_mean = (a_t * s_src.square() * x_t
              - a_src * s_t.square() * x_t_src) / denom
    g_var = s_t.square() * s_src.square() / denom
    gaussian = dict(mean=g_mean, var=g_var[..., :1])
    return gm_mul_iso_gaussian(gm_x0, gaussian, 1.0, 1.0, eps=eps)[0]


def gmflow_posterior_mean(gm_x0, x_t, x_t_src, sigma_t, sigma_t_src,
                          eps: float = 1e-6) -> Tensor:
    return gm_to_mean(gmflow_posterior(gm_x0, x_t, x_t_src, sigma_t,
                                       sigma_t_src, eps=eps))


def gm_samples_to_gaussian_samples_cl(gm_u: Dict[str, Tensor], u: Tensor
                                      ) -> Tensor:
    """KR whitening of one sample per element, u (B, H, W, C), as the
    spectral loss uses it."""
    return gm_samples_to_gaussian_samples(gm_u, u[:, None]).squeeze(1)


def _full(value, b: int, like: Tensor) -> Tensor:
    return torch.full((b,), float(value), dtype=torch.float32,
                      device=like.device)


@MODULES.register_module()
class GMFlow(GaussianFlow):
    """Flow matching with a mixture-valued denoiser ``nn.Module``;
    ``spectrum_net`` (an ``nn.Module`` from iso-Gaussian x0 statistics to a
    log power spectrum, or its ``MODULES`` config) adds the spectral loss
    when given."""

    def __init__(self, *args, spectrum_net=None,
                 spectral_loss_weight: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.spectrum_net = MODULES.build(spectrum_net, default_args=(
            denoiser_args(kwargs.get('device'), kwargs.get('dtype'))))
        self.spectral_loss_weight = spectral_loss_weight

    # ---- GM-space conversions ------------------------------------------------
    def u_to_x_0(self, denoising_output, x_t: Tensor, t=None, sigma=None,
                 eps: float = 1e-6):
        """Velocity-space GM, Gaussian {mean, var} or sample -> x0 space."""
        if sigma is None:
            sigma = torch.as_tensor(t, dtype=torch.float32) \
                / self.num_timesteps
        s = _bview(sigma, x_t.dim())
        if isinstance(denoising_output, dict) and \
                'logweights' in denoising_output:
            s = s.unsqueeze(-4)
            return dict(means=x_t.unsqueeze(-4)
                        - s * denoising_output['means'],
                        logstds=denoising_output['logstds']
                        + torch.log(s.clamp_min(eps)),
                        logweights=denoising_output['logweights'])
        if isinstance(denoising_output, dict):
            return dict(mean=x_t - s * denoising_output['mean'],
                        var=denoising_output['var'] * s.square())
        return x_t - s * denoising_output

    def reverse_transition(self, denoising_output, x_t_high: Tensor,
                           sigma_low: Tensor, sigma_high: Tensor,
                           generator: Optional[torch.Generator] = None,
                           eps: float = 1e-6, prediction_type: str = 'u'):
        """Reverse bridge x_{t_low} | x_{t_high} and the x0 estimate: a GM
        for a GM output, a draw (from ``generator``) for a sample output;
        sigmas are (B,)."""
        nd = x_t_high.dim()
        sigma = _bview(sigma_high, nd)
        sigma_to = _bview(sigma_low, nd)
        alpha = 1 - sigma
        alpha_to = 1 - sigma_to
        r_sig = sigma_to / sigma.clamp_min(eps)
        r_alp = alpha / alpha_to.clamp_min(eps)
        beta_over_sigma_sq = 1 - (r_sig * r_alp).square()
        c1 = r_sig.square() * r_alp
        c2 = beta_over_sigma_sq * alpha_to

        if isinstance(denoising_output, dict):
            x_high = x_t_high.unsqueeze(-4)
            c1k, c2k = c1.unsqueeze(-4), c2.unsqueeze(-4)
            c3 = (beta_over_sigma_sq * sigma_to.square()).unsqueeze(-4)
            sk = sigma.unsqueeze(-4)
            if prediction_type == 'u':
                means_x0 = x_high - sk * denoising_output['means']
                scale = sk * c2k
            elif prediction_type == 'x0':
                means_x0 = denoising_output['means']
                scale = c2k
            else:
                raise ValueError(f'invalid prediction_type {prediction_type}')
            logstds = torch.logaddexp(
                2 * (denoising_output['logstds']
                     + torch.log(scale.clamp_min(eps))),
                torch.log(c3.clamp_min(eps))) / 2
            return dict(means=c1k * x_high + c2k * means_x0, logstds=logstds,
                        logweights=denoising_output['logweights'])

        if generator is None:
            raise ValueError('a sample-mode reverse transition needs a '
                             'generator')
        c3_sqrt = torch.sqrt(beta_over_sigma_sq.clamp_min(0.0)) * sigma_to
        x_0 = x_t_high - sigma * denoising_output \
            if prediction_type == 'u' else denoising_output
        noise = torch.randn(x_t_high.shape, generator=generator,
                            device=x_t_high.device, dtype=torch.float32)
        return c1 * x_t_high + c2 * x_0 + c3_sqrt * noise

    # ---- training ---------------------------------------------------------------
    def transition_loss(self, denoising_output, x_t_low, x_t_high, t_low,
                        t_high):
        gm_low = self.reverse_transition(
            denoising_output, x_t_high, t_low / self.num_timesteps,
            t_high / self.num_timesteps)
        loss_kwargs = dict(gm_low)
        loss_kwargs.update(x_t_low=x_t_low, timesteps=t_high)
        return self.flow_loss(loss_kwargs)

    def spectral_loss(self, denoising_output, x_0: Tensor, x_t: Tensor,
                      t: Tensor, eps: float = 1e-6) -> Tensor:
        """Spectrum-net NLL on KR-whitened residuals; the whitening is
        detached, as the JAX module stops its gradient."""
        inv_sigma = self.num_timesteps / _bview(
            t.to(torch.float32), x_t.dim()).clamp_min(eps)
        gauss_x0 = self.u_to_x_0(gm_to_iso_gaussian(denoising_output)[0],
                                 x_t, t)
        u = (x_t - x_0) * inv_sigma
        with torch.no_grad():
            z_kr = gm_samples_to_gaussian_samples_cl(denoising_output, u)
        z_fft = torch.fft.fft2(z_kr, dim=(-3, -2), norm='ortho')
        z = z_fft.real + z_fft.imag
        log_var = self.spectrum_net(gauss_x0['mean'], gauss_x0['var'])
        loss = z.square() * (torch.exp(-log_var) - 1) + log_var
        return loss.mean() * (0.5 * self.spectral_loss_weight)

    def forward_train(self, generator: torch.Generator, x_0: Tensor,
                      **kwargs):
        """(loss, log_vars) of one batch: draws t_high (the timestep
        sampler), then the noise of x_{t_low} and of the transition to
        x_{t_high}, in that order."""
        num_batches = x_0.shape[0]
        seq_len = math.prod(x_0.shape[1:-1]) if x_0.dim() > 2 else None
        trans_ratio = self.train_cfg.get('trans_ratio', 1.0)
        eps = self.train_cfg.get('eps', 1e-4)

        t_high = self.timestep_sampler(generator, num_batches,
                                       seq_len=seq_len, device=x_0.device
                                       ).clamp(eps, self.num_timesteps)
        t_low = torch.minimum(t_high * (1 - trans_ratio),
                              t_high - eps).clamp_min(0.0)

        noise_0 = torch.randn(x_0.shape, generator=generator,
                              device=x_0.device, dtype=torch.float32)
        x_t_low = self.sample_forward_diffusion(x_0, t_low, noise_0)[0]
        x_t_high = self.sample_forward_transition(
            generator, x_t_low, t_low / self.num_timesteps,
            t_high / self.num_timesteps)

        denoising_output = self.pred(x_t_high, t_high, **kwargs)
        loss, log_info = self.transition_loss(
            denoising_output, x_t_low, x_t_high, t_low, t_high)
        log_vars = dict(loss_transition=loss.detach(), **log_info)
        if self.spectrum_net is not None:
            loss_spectral = self.spectral_loss(denoising_output, x_0,
                                               x_t_high, t_high)
            log_vars['loss_spectral'] = loss_spectral.detach()
            loss = loss + loss_spectral
        log_vars['loss_diffusion'] = loss.detach()
        return loss, log_vars

    # ---- CFG in GM space ------------------------------------------------------
    def _apply_probabilistic_cfg(self, gm_x0, num_batches: int,
                                 guidance_scale: float, orthogonal: float):
        """The 2B batch is [uncond, cond]: (gm_out, gaussian_out, gm_cond,
        gaussian_cond, cfg_bias, avg_var)."""
        gm_uncond = {k: v[:num_batches] for k, v in gm_x0.items()}
        gm_cond = {k: v[num_batches:] for k, v in gm_x0.items()}
        uncond_mean = gm_to_mean(gm_uncond)
        gaussian_cond = gm_to_iso_gaussian(gm_cond)[0]
        gaussian_cond['var'] = gaussian_cond['var'].mean(dim=(-3, -2),
                                                         keepdim=True)
        gaussian_out, cfg_bias, avg_var = probabilistic_guidance(
            gaussian_cond['mean'], gaussian_cond['var'], uncond_mean,
            guidance_scale, orthogonal=orthogonal)
        gm_out = gm_mul_iso_gaussian(
            gm_cond,
            iso_gaussian_mul_iso_gaussian(gaussian_out, gaussian_cond, 1, -1),
            1, 1)[0]
        return gm_out, gaussian_out, gm_cond, gaussian_cond, cfg_bias, avg_var

    # ---- sampling ----------------------------------------------------------------
    def _guided_x0(self, x: Tensor, t: Tensor, use_guidance: bool, **kwargs):
        """One denoiser call (on [x, x] with guidance) -> x0-space GM."""
        x_in, t_in = x, t
        if use_guidance:
            x_in, t_in = torch.cat([x, x], dim=0), torch.cat([t, t], dim=0)
        gm_u = {k: v.float() for k, v in self.pred(x_in, t_in,
                                                   **kwargs).items()}
        return self.u_to_x_0(gm_u, x_in, t_in), gm_u

    @torch.no_grad()
    def forward_test(self, noise: Tensor,
                     generator: Optional[torch.Generator] = None,
                     guidance_scale: float = 0.0,
                     test_cfg_override: Optional[dict] = None,
                     **kwargs) -> Tensor:
        """GM-ODE/SDE sampling from ``noise`` (B, H, W, C): orders 1 and 2,
        posterior-mean substeps, output modes 'mean' and 'sample',
        probabilistic CFG for guidance_scale in (0, 1)."""
        cfg = copy.deepcopy(self.test_cfg)
        cfg.update(test_cfg_override or {})
        output_mode = cfg.get('output_mode', 'mean')
        num_timesteps = cfg.get('num_timesteps', 32)
        num_substeps = cfg.get('num_substeps', 1)
        orthogonal = cfg.get('orthogonal_guidance', 1.0)
        order = cfg.get('order', 1)
        ca, cb = cfg.get('gm2_coefs', [0.005, 1.0])
        use_guidance = 0.0 < guidance_scale < 1.0
        if order not in (1, 2):
            raise ValueError(f'order must be 1 or 2, got {order}')

        scheduler = self.build_test_scheduler(cfg)
        seq_len = math.prod(noise.shape[1:-1]) if noise.dim() > 2 else None
        sigmas = scheduler.set_timesteps(num_timesteps * num_substeps,
                                         seq_len=seq_len)
        b = noise.shape[0]
        x = noise.to(torch.float32)
        prev = None
        for step_id in range(num_timesteps):
            idx = step_id * num_substeps
            sigma = sigmas[idx]
            t = _full(sigma * np.float32(self.num_timesteps), b, x)
            gm_x0, _ = self._guided_x0(x, t, use_guidance, **kwargs)
            if use_guidance:
                (gm_out, gaussian_out, gm_cond, gaussian_cond, cfg_bias,
                 avg_var) = self._apply_probabilistic_cfg(
                    gm_x0, b, guidance_scale, orthogonal)
            else:
                gm_out = gm_x0
                gaussian_out = gm_to_iso_gaussian(gm_out)[0]
                gm_cond = gaussian_cond = cfg_bias = avg_var = None

            if order == 2:
                gm_out, gaussian_out = self._gm_2nd_order(
                    gm_out, gaussian_out, x, sigma, step_id, sigmas,
                    num_substeps, prev,
                    guidance_scale if use_guidance else 0.0,
                    gm_cond, gaussian_cond, avg_var, cfg_bias, ca, cb)
                prev = dict(gm=gm_out, x_t=x, sigma=sigma,
                            h=sigma - sigmas[min(idx + num_substeps,
                                                 len(sigmas) - 1)])

            # substep 0: the model output from the (corrected) GM
            if output_mode == 'mean':
                model_output = gm_to_mean(gm_out)
            else:
                model_output = gm_to_sample(generator, gm_out,
                                            n_samples=1).squeeze(1)
            x_new = scheduler.step(model_output, x, sigma, sigmas[idx + 1],
                                   prediction_type='x0', generator=generator)
            # posterior-mean substeps
            for sub in range(1, num_substeps):
                s_sub = sigmas[idx + sub]
                model_output = gmflow_posterior_mean(
                    gm_out, x_new, x, _full(s_sub, b, x), _full(sigma, b, x))
                x_new = scheduler.step(model_output, x_new, s_sub,
                                       sigmas[idx + sub + 1],
                                       prediction_type='x0',
                                       generator=generator)
            x = x_new
        return x.to(noise.dtype)

    def _gm_2nd_order(self, gm_out, gaussian_out, x_t, sigma, step_id,
                      sigmas, num_substeps, prev, guidance_scale, gm_cond,
                      gaussian_cond, avg_var, cfg_bias, ca, cb):
        """2nd-order mean correction fused with the CFG bias; no correction
        on the first step (``prev`` None)."""
        dims = tuple(range(1, x_t.dim()))
        if cfg_bias is not None:
            gm_mean = gm_to_mean(gm_out)
            base_gaussian, base_gm = gaussian_cond, gm_cond
        else:
            gm_mean = gaussian_out['mean']
            base_gaussian = dict(
                mean=gaussian_out['mean'],
                var=gaussian_out['var'].mean(dim=(-3, -2), keepdim=True))
            avg_var = base_gaussian['var'].mean(dims, keepdim=True)
            base_gm = gm_out
            cfg_bias = torch.zeros_like(gm_mean)

        if prev is None:
            mean_diff = torch.zeros_like(gm_mean)
        else:
            b = x_t.shape[0]
            mean_from_prev = gmflow_posterior_mean(
                prev['gm'], x_t, prev['x_t'], _full(sigma, b, x_t),
                _full(prev['sigma'], b, x_t))
            h = sigma - sigmas[min((step_id + 1) * num_substeps,
                                   len(sigmas) - 1)]
            k = np.float32(0.5) * h / max(prev['h'], np.float32(1e-8))
            gs = guidance_scale * cb
            err_power = avg_var * (gs * gs + ca)
            scale = torch.sqrt((1 - err_power / max(
                prev['h'] ** 2, np.float32(1e-12))).clamp_min(0.0)) * k
            mean_diff = (gm_mean - mean_from_prev) * scale

        bias = mean_diff + cfg_bias
        bias_power = bias.square().mean(dims, keepdim=True)
        bias = bias * torch.sqrt((avg_var / bias_power.clamp_min(1e-6)
                                  ).clamp_max(1.0))
        gaussian_new = dict(
            mean=base_gaussian['mean'] + bias,
            var=base_gaussian['var'] * (
                1 - bias_power / avg_var.clamp_min(1e-6)).clamp_min(1e-6))
        gm_new = gm_mul_iso_gaussian(
            base_gm,
            iso_gaussian_mul_iso_gaussian(gaussian_new, base_gaussian, 1, -1),
            1, 1)[0]
        return gm_new, gaussian_new

    # ---- teacher-style u query ---------------------------------------------------
    def forward_u(self, x_t: Tensor, t: Tensor, guidance_scale: float = 0.0,
                  test_cfg_override: Optional[dict] = None, **kwargs):
        """Mean velocity at (x_t, t); with guidance_scale in (0, 1) the
        probabilistic-CFG mixture's mean, back in u space."""
        cfg = copy.deepcopy(self.test_cfg)
        cfg.update(test_cfg_override or {})
        use_guidance = 0.0 < guidance_scale < 1.0
        gm_x0, gm_u = self._guided_x0(x_t, t, use_guidance, **kwargs)
        if not use_guidance:
            return gm_to_mean(gm_u)
        gm_out = self._apply_probabilistic_cfg(
            gm_x0, x_t.shape[0], guidance_scale,
            cfg.get('orthogonal_guidance', 1.0))[0]
        sigma = _bview(torch.as_tensor(t, dtype=torch.float32)
                       / self.num_timesteps, x_t.dim())
        return (x_t - gm_to_mean(gm_out)) / sigma.clamp_min(1e-6)
