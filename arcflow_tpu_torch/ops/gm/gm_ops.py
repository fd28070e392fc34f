"""Gaussian-mixture operations library.

Counterpart of ``arcflow_tpu/ops/gm/gm_ops.py``: moment matching,
Gaussian/GM products, sampling, log-probs, spectral log-probs, KL/entropy
estimates, temperature, Knothe-Rosenblatt (KR) transport in both
directions, and the Newton-Raphson 1-D inverse CDF whose no-grad steps run
the Hopper kernel of ``inverse_cdf.py``.

Conventions (channel-last, as in the JAX package):
    GM dict: means (*B, K, H, W, C); logstds broadcastable to means,
        typically (*B, 1, 1, 1, 1); logweights (*B, K, H, W, 1), normalized
        over K; optional cached gm_vars, gm_weights.
    Full-covariance GM (from gm_mul_gaussian): means (*B, K, H, W, C),
        covs (*B, 1|K, H, W, C, C), logweights (*B, K, H, W, 1).
    Gaussian dict: mean (*B, H, W, C), var (*B, H, W, 1) (iso) or
        cov (*B, H, W, C, C).
    Samples: (*B, N, H, W, C).

Functions are pure and compute in the inputs' dtype (fp32 throughout the
callers); sampling draws from an explicit ``torch.Generator`` where the JAX
functions take a PRNG key, so the draws differ from JAX's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from . import inverse_cdf as _icdf

Tensor = torch.Tensor
SQRT2 = math.sqrt(2.0)
LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)


def _gm_vars(gm: Dict[str, Tensor]) -> Tensor:
    if 'gm_vars' in gm:
        return gm['gm_vars']
    return torch.exp(2.0 * gm['logstds'])


def _gm_weights(gm: Dict[str, Tensor]) -> Tensor:
    if 'gm_weights' in gm:
        return gm['gm_weights']
    return torch.exp(gm['logweights'])


# ---------------------------------------------------------------- moments ----

def gm_to_mean(gm: Dict[str, Tensor], gm_power: float = 1.0) -> Tensor:
    """Mixture mean (optionally of the power-sharpened mixture) ->
    (*B, H, W, C)."""
    w = torch.softmax(gm['logweights'] * gm_power, dim=-4)
    return (w * gm['means']).sum(dim=-4)


def gm_to_iso_gaussian(gm: Dict[str, Tensor]
                       ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Moment-match to an isotropic Gaussian: (gaussian {mean (*B,H,W,C),
    var (*B,H,W,1)}, gm_diffs (*B,K,H,W,C)); the variance is the
    channel-averaged total variance."""
    w = _gm_weights(gm)
    mean = (w * gm['means']).sum(dim=-4)
    diffs = gm['means'] - mean.unsqueeze(-4)
    if 'covs' in gm:
        comp_var = torch.diagonal(gm['covs'], dim1=-2, dim2=-1).mean(
            dim=-1, keepdim=True)                     # (*B, 1|K, H, W, 1)
        comp_var = (w * comp_var).sum(dim=-4) if comp_var.shape[-4] > 1 \
            else comp_var.squeeze(-4)
    else:
        comp_var = _gm_vars(gm)
        comp_var = (w * comp_var).sum(dim=-4) if comp_var.shape[-4] > 1 \
            else comp_var.squeeze(-4)
        if comp_var.shape[-1] > 1:
            comp_var = comp_var.mean(-1, keepdim=True)
    var = (w * diffs.square()).sum(dim=-4).mean(-1, keepdim=True) + comp_var
    return dict(mean=mean, var=var), diffs


def gm_to_gaussian(gm: Dict[str, Tensor], cov_scale: float = 1.0
                   ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Moment-match to a full-covariance Gaussian: (gaussian {mean
    (*B,H,W,C), cov (*B,H,W,C,C)}, gm_diffs)."""
    c = gm['means'].shape[-1]
    w = _gm_weights(gm)
    mean = (w * gm['means']).sum(dim=-4)
    diffs = gm['means'] - mean.unsqueeze(-4)
    cov = (w[..., None] * diffs[..., :, None] * diffs[..., None, :]
           ).sum(dim=-5)                                   # (*B,H,W,C,C)
    if 'covs' in gm:
        covs = gm['covs']
        covs = (w[..., None] * covs).sum(dim=-5) if covs.shape[-5] > 1 \
            else covs.squeeze(-5)
        cov = cov + covs
    else:
        eye = torch.eye(c, dtype=cov.dtype, device=cov.device)
        cov = cov + eye * _gm_vars(gm)[..., None].squeeze(-5)
    return dict(mean=mean, cov=cov * cov_scale), diffs


# ---------------------------------------------------------------- products ----

def iso_gaussian_mul_iso_gaussian(g1: Dict[str, Tensor],
                                  g2: Dict[str, Tensor],
                                  power1: float = 1.0, power2: float = 1.0,
                                  eps: float = 1e-6) -> Dict[str, Tensor]:
    """Precision-weighted product of two isotropic Gaussians (with powers)."""
    norm = torch.clamp_min(power1 * g2['var'] + power2 * g1['var'], eps)
    var = g1['var'] * g2['var'] / norm
    mean = (power1 * g2['var'] * g1['mean']
            + power2 * g1['var'] * g2['mean']) / norm
    return dict(mean=mean, var=var)


def gaussian_mul_gaussian(g1: Dict[str, Tensor], g2: Dict[str, Tensor],
                          power1: float = 1.0, power2: float = 1.0
                          ) -> Dict[str, Tensor]:
    """Full-covariance Gaussian product."""
    p1 = power1 * torch.linalg.inv(g1['cov'])
    p2 = power2 * torch.linalg.inv(g2['cov'])
    cov = torch.linalg.inv(p1 + p2)
    mean = (cov @ (p1 @ g1['mean'][..., None]
                   + p2 @ g2['mean'][..., None]))[..., 0]
    return dict(mean=mean, cov=cov)


def gm_mul_iso_gaussian(gm: Dict[str, Tensor], gaussian: Dict[str, Tensor],
                        gm_power: float = 1.0, gaussian_power: float = 1.0,
                        eps: float = 1e-6) -> Tuple[Dict[str, Tensor], float]:
    """GM^a * N^b -> GM (posterior fusion); the Gaussian's var is
    (*B, H, W, 1)."""
    g_mean = gaussian['mean'].unsqueeze(-4)             # (*B,1,H,W,C)
    g_var = gaussian['var'].unsqueeze(-4)               # (*B,1,H,W,1)
    g_logstd = gaussian.get('logstd')
    g_logstd = 0.5 * torch.log(g_var) if g_logstd is None \
        else g_logstd.unsqueeze(-4)
    gm_vars = _gm_vars(gm)

    diffs = gm['means'] - g_mean
    power_ratio = gaussian_power / gm_power
    norm = torch.clamp_min(g_var + power_ratio * gm_vars, eps)
    out_means = (g_var * gm['means'] + power_ratio * gm_vars * g_mean) / norm
    lw_delta = diffs.square().sum(-1, keepdim=True) \
        * (-0.5 * power_ratio / norm)
    out_logweights = torch.log_softmax(gm['logweights'] + lw_delta, dim=-4)
    out_logstds = gm['logstds'] + g_logstd - 0.5 * torch.log(norm)
    return dict(means=out_means, logstds=out_logstds,
                logweights=out_logweights), gm_power


def gm_mul_gaussian(gm: Dict[str, Tensor], gaussian: Dict[str, Tensor],
                    gm_power: float = 1.0, gaussian_power: float = 1.0
                    ) -> Tuple[Dict[str, Tensor], float]:
    """GM^a * N^b with a full-covariance Gaussian -> full-covariance GM."""
    c = gm['means'].shape[-1]
    gm_vars = _gm_vars(gm)[..., None]                  # (*B,1,1,1,1,1)
    g_mean = gaussian['mean']                          # (*B,H,W,C)
    g_cov = gaussian['cov']                            # (*B,H,W,C,C)

    eye = torch.eye(c, dtype=g_cov.dtype, device=g_cov.device)
    gm_prec = eye / gm_vars.squeeze(-5)
    g_prec = (gaussian_power / gm_power) * torch.linalg.inv(g_cov)
    out_covs = torch.linalg.inv(gm_prec + g_prec)      # (*B,H,W,C,C)

    rhs = gm['means'] / _gm_vars(gm) \
        + (g_prec @ g_mean[..., None])[..., 0].unsqueeze(-4)
    out_means = (out_covs.unsqueeze(-5) @ rhs[..., None])[..., 0]

    gm_covs = eye * _gm_vars(gm)[..., None]
    diffs = gm['means'] - g_mean.unsqueeze(-4)
    mix_cov = gm_covs * gaussian_power + g_cov.unsqueeze(-5) * gm_power
    sol = torch.linalg.solve(mix_cov, diffs[..., None])[..., 0]
    lw_delta = (-0.5 * gaussian_power) * (diffs * sol).sum(-1, keepdim=True)
    out_logweights = torch.log_softmax(gm['logweights'] + lw_delta, dim=-4)
    return dict(means=out_means, covs=out_covs.unsqueeze(-5),
                logweights=out_logweights), gm_power


def gm_mul_gm(gm1: Dict[str, Tensor], gm2: Dict[str, Tensor]
              ) -> Dict[str, Tensor]:
    """Product of two isotropic GMs -> GM with K1*K2 components."""
    m1 = gm1['means'].unsqueeze(-4)                  # (*B,K1,1,H,W,C)
    m2 = gm2['means'].unsqueeze(-5)                  # (*B,1,K2,H,W,C)
    v1 = _gm_vars(gm1).unsqueeze(-4)
    v2 = _gm_vars(gm2).unsqueeze(-5)
    lw1 = gm1['logweights'].unsqueeze(-4)
    lw2 = gm2['logweights'].unsqueeze(-5)

    norm = v1 + v2
    out_means = (v2 * m1 + v1 * m2) / norm
    lw_delta = (m1 - m2).square().sum(-1, keepdim=True) * (-0.5 / norm)
    out_logweights = lw1 + lw2 + lw_delta

    # collapse (K1, K2) at dims (-5, -4) into one component axis
    shp = out_means.shape
    out_means = out_means.reshape(*shp[:-5], shp[-5] * shp[-4], *shp[-3:])
    out_logweights = out_logweights.broadcast_to(shp[:-1] + (1,))
    out_logweights = torch.log_softmax(out_logweights.reshape(
        *shp[:-5], shp[-5] * shp[-4], *shp[-3:-1], 1), dim=-4)
    out_logstds = gm1['logstds'] + gm2['logstds'] - 0.5 * torch.logaddexp(
        2 * gm1['logstds'], 2 * gm2['logstds'])
    return dict(means=out_means, logstds=out_logstds,
                logweights=out_logweights)


# ---------------------------------------------------------------- sampling ----

def gm_to_sample(generator: Optional[torch.Generator], gm: Dict[str, Tensor],
                 gm_power: float = 1.0, n_samples: int = 1,
                 cov_sharpen: bool = False) -> Tensor:
    """Categorical + reparameterized draw -> (*B, N, H, W, C): per element a
    component from the (power-sharpened) weights, then its mean plus its
    std times a standard normal draw."""
    means = gm['means']
    k = means.shape[-4]
    logits = (gm['logweights'] * gm_power).squeeze(-1)     # (*B,K,H,W)
    logits = logits.movedim(-3, -1)                        # (*B,H,W,K)
    probs = torch.softmax(logits, dim=-1)
    inds = torch.multinomial(probs.reshape(-1, k), n_samples,
                             replacement=True, generator=generator)
    inds = inds.reshape(*logits.shape[:-1], n_samples).movedim(-1, -3)
    one_hot = torch.nn.functional.one_hot(inds, k).to(means.dtype)
    sel_means = torch.einsum('...nhwk,...khwc->...nhwc', one_hot, means)

    stds = torch.exp(gm['logstds'])
    if cov_sharpen:
        stds = stds / math.sqrt(gm_power)
    if stds.shape[-4] == k and k > 1:                      # per-component
        sel_stds = torch.einsum('...nhwk,...khwc->...nhwc', one_hot,
                                stds.broadcast_to(means.shape))
    else:
        sel_stds = stds.squeeze(-4).unsqueeze(-4)
    noise = torch.randn(sel_means.shape, generator=generator,
                        device=means.device, dtype=sel_means.dtype)
    return sel_means + sel_stds * noise


# ---------------------------------------------------------------- log-probs ----

def iso_gaussian_logprob(gaussian: Dict[str, Tensor], samples: Tensor
                         ) -> Tensor:
    """log N(samples; mean, var I) summed over channels -> (*B, N, H, W)."""
    mean = gaussian['mean'].unsqueeze(-4)
    var = gaussian['var'].unsqueeze(-4).squeeze(-1)
    c = mean.shape[-1]
    diff2 = (samples - mean).square().sum(-1)
    return -0.5 * diff2 / var - 0.5 * c * torch.log(var) - c * LOG_SQRT_2PI


def gm_logprob(gm: Dict[str, Tensor], samples: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """Mixture log-density of samples: (logprob (*B, N, H, W), per-component
    Gaussian log-probs (*B, N, K, H, W))."""
    c = gm['means'].shape[-1]
    const = -c * LOG_SQRT_2PI
    if 'covs' in gm:
        covs = gm['covs']                                  # (*B,1|K,H,W,C,C)
        invcov_trils = gm.get('invcov_trils')
        if invcov_trils is None:
            invcov_trils = torch.linalg.cholesky(torch.linalg.inv(covs))
        logdets = gm.get('logdets')
        if logdets is None:
            logdets = torch.linalg.slogdet(covs)[1]
        diffs = samples.unsqueeze(-4) - gm['means'].unsqueeze(-5)
        dw = torch.einsum('...c,...cd->...d', diffs,
                          invcov_trils.unsqueeze(-6))
        glp = -0.5 * (dw.square().sum(-1) + logdets.unsqueeze(-4)) + const
    else:
        inv_std = torch.exp(-gm['logstds'])
        diffs = (samples.unsqueeze(-4) - gm['means'].unsqueeze(-5)) \
            * inv_std.unsqueeze(-5)
        # sum of per-channel log stds (broadcast-safe for per-K/per-C stds)
        sum_logstd = gm['logstds'].broadcast_to(gm['means'].shape).sum(-1)
        glp = -0.5 * diffs.square().sum(-1) - sum_logstd.unsqueeze(-4) \
            + const
    lw = gm['logweights'].squeeze(-1).unsqueeze(-4)        # (*B,1,K,H,W)
    return torch.logsumexp(lw + glp, dim=-3), glp


def gm_spectral_logprobs(gm: Dict[str, Tensor], samples: Tensor,
                         power_spectrum: Optional[Tensor] = None,
                         spectral_samples: Optional[Tensor] = None,
                         n_axes: Optional[int] = None, eps: float = 1e-6,
                         axis_aligned: bool = True) -> Tensor:
    """Spatially summed logprob with an optional FFT power-spectrum
    reweighting term -> (*B, N)."""
    logprobs = gm_logprob(gm, samples)[0].sum(dim=(-2, -1))
    if power_spectrum is not None:
        if spectral_samples is None:
            z_kr = gm_samples_to_gaussian_samples(
                gm, samples, n_axes=n_axes, eps=eps, axis_aligned=axis_aligned)
            z_fft = torch.fft.fft2(z_kr, dim=(-3, -2), norm='ortho')
            spectral_samples = z_fft.real + z_fft.imag
        c = spectral_samples.shape[-1]
        ps = power_spectrum.unsqueeze(-4)     # (*B, 1, H, W, 1|C)
        diff = -0.5 * spectral_samples.square().sum(-1) \
            * (torch.exp(-ps).squeeze(-1) - 1.0) - 0.5 * c * ps.squeeze(-1)
        logprobs = logprobs + diff.sum(dim=(-2, -1))
    return logprobs


def gm_kl_div(generator: Optional[torch.Generator], gm_p: Dict[str, Tensor],
              gm_q: Dict[str, Tensor], n_samples: int = 32) -> Tensor:
    """Monte Carlo estimate of KL(p || q) -> (*B, 1, H, W)."""
    samples = gm_to_sample(generator, gm_p, 1.0, n_samples=n_samples)
    kl = gm_logprob(gm_p, samples)[0] - gm_logprob(gm_q, samples)[0]
    return kl.mean(dim=-3, keepdim=True)


def gm_entropy(generator: Optional[torch.Generator], gm: Dict[str, Tensor],
               n_samples: int = 32) -> Tensor:
    samples = gm_to_sample(generator, gm, 1.0, n_samples=n_samples)
    return -gm_logprob(gm, samples)[0].mean(dim=-3, keepdim=True)


# ------------------------------------------------------------- temperature ----

def gm_temperature(gm: Dict[str, Tensor], temperature: float,
                   eps: float = 1e-6) -> Dict[str, Tensor]:
    """Sharpen/soften: logweights / T, logstds + log(T) / 2."""
    gm = dict(gm)
    temperature = max(temperature, eps)
    gm['logweights'] = torch.log_softmax(gm['logweights'] / temperature,
                                         dim=-4)
    if 'logstds' in gm:
        gm['logstds'] = gm['logstds'] + 0.5 * math.log(temperature)
    if 'gm_vars' in gm:
        gm['gm_vars'] = gm['gm_vars'] * temperature
    return gm


def gm_transpose_t_first(gm: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Video GM: (B, K, T, H, W, C) -> (B, T, K, H, W, C) for every tensor
    of 6 or more dims. (The JAX function moves axis -5 to -5, which leaves
    every tensor as it is; the port does what its docstring says.)"""
    return {k: v.movedim(-5, -4) if v.dim() >= 6 else v
            for k, v in gm.items()}


# ------------------------------------------------- 1-D mixture inverse CDF ----

def gm1d_pdf_cdf(gm1d: Dict[str, Tensor], samples: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """1-D mixture pdf and [-1, 1]-scaled cdf.

    gm1d: means/logweights (..., G, H, W), logstds broadcastable
    (..., 1, 1, 1); samples (..., N, H, W). Returns pdf, cdf (..., N, H, W).
    """
    logstds = gm1d['logstds'].unsqueeze(-4)
    stds = torch.exp(logstds)
    logweights = gm1d['logweights'].unsqueeze(-4)
    weights = gm1d.get('gm_weights')
    weights = torch.exp(logweights) if weights is None \
        else weights.unsqueeze(-4)
    norm_diffs = (samples.unsqueeze(-3) - gm1d['means'].unsqueeze(-4)) / stds
    pdf = torch.exp(-0.5 * norm_diffs.square() - logstds
                    + logweights).sum(-3) / math.sqrt(2 * math.pi)
    cdf = (weights * torch.erf(norm_diffs / SQRT2)).sum(-3)
    return pdf, cdf


def gm1d_inverse_cdf(gm1d: Dict[str, Tensor], scaled_cdfs: Tensor,
                     n_steps: int = 8, eps: float = 1e-6,
                     max_step_size: float = 1.5,
                     gaussian_samples: Optional[Tensor] = None,
                     backward_steps: int = 2) -> Tensor:
    """Invert the 1-D mixture CDF by Newton-Raphson, in two tiers as the
    JAX function does: the first ``n_steps - backward_steps`` steps run the
    kernel (``inverse_cdf.gm1d_inverse_cdf_kernel``; its plain version on CPU
    tensors) under no_grad and are detached; then, when ``backward_steps``
    > 0, ``n_steps`` (not ``backward_steps``) differentiable plain steps
    follow, as the JAX code runs them (``gm_ops.py:454-456``).

    scaled_cdfs: target CDF values in [-1, 1], shape (..., N, H, W).
    Returns samples (..., N, H, W).
    """
    means = gm1d['means']
    logweights = gm1d['logweights']
    weights = gm1d.get('gm_weights')
    if weights is None:
        weights = torch.exp(logweights)
    logstds = gm1d['logstds']
    stds = torch.exp(logstds)

    # isotropic proxy for the initialization
    mean = (weights * means).sum(-3, keepdim=True)             # (...,1,H,W)
    var = (weights * (means - mean).square()).sum(-3, keepdim=True) \
        + stds.square()
    if gaussian_samples is None:
        gaussian_samples = torch.erfinv(
            scaled_cdfs.clamp(-1 + eps, 1 - eps)) * SQRT2
    samples = gaussian_samples * torch.sqrt(var) + mean

    nograd_steps = max(n_steps - backward_steps, 0)
    clamp = max_step_size * stds

    def nr_step(s):
        pdf, cdf = gm1d_pdf_cdf(dict(means=means, logstds=logstds,
                                     logweights=logweights,
                                     gm_weights=weights), s)
        delta = 0.5 * (cdf - scaled_cdfs) / pdf.clamp_min(eps)
        return s - torch.clamp(delta, -clamp, clamp)

    if nograd_steps > 0:
        with torch.no_grad():
            samples = _icdf.gm1d_inverse_cdf_kernel(
                means, logweights, weights, logstds, scaled_cdfs, samples,
                n_steps=nograd_steps, eps=eps, max_step_size=max_step_size)
    for _ in range(n_steps if backward_steps > 0 else 0):
        samples = nr_step(samples)
    return samples


# ----------------------------------------------- Knothe-Rosenblatt transport ----

def _kr_eigvecs(gm: Dict[str, Tensor], axis_aligned: bool) -> Tensor:
    """Eigenvectors of the moment-matched covariance (averaged over H, W
    when ``axis_aligned``), columns in descending eigenvalue order, detached.
    Their signs are ``torch.linalg.eigh``'s, which may differ from JAX's."""
    covs = gm_to_gaussian(gm)[0]['cov']                     # (*B,H,W,C,C)
    if axis_aligned:
        covs = covs.mean(dim=(-4, -3), keepdim=True)        # (*B,1,1,C,C)
    return torch.linalg.eigh(covs)[1].flip(-1).detach()


def _kr_to_gaussian(gm: Dict[str, Tensor], gm_samples: Tensor,
                    eigvecs: Tensor, n_axes: int, eps: float,
                    generator: Optional[torch.Generator],
                    axis_aligned: bool) -> Tensor:
    """GM -> standard Gaussian with the given (*B, 1|H, 1|W, C, C)
    eigenvectors."""
    c = gm['means'].shape[-1]
    ev = eigvecs[..., :n_axes]
    # rotate means/samples: (*B,K|N,H,W,C) @ (C,A)
    means_rot = torch.einsum('...khwc,...hwcd->...khwd', gm['means'], ev)
    samples_rot = torch.einsum('...nhwc,...hwcd->...nhwd', gm_samples, ev)

    stds = torch.exp(gm['logstds'])                         # (*B,1,1,1,1)
    # (*B,N,K,H,W,A)
    norm_diffs = (samples_rot.unsqueeze(-4) - means_rot.unsqueeze(-5)) \
        / stds.unsqueeze(-5)
    nd_sq_cum = torch.cumsum(norm_diffs[..., :-1].square(), dim=-1)
    slice_logw = gm['logweights'].unsqueeze(-5) - 0.5 * nd_sq_cum
    slice_w = torch.softmax(slice_logw, dim=-4)
    w0 = _gm_weights(gm).unsqueeze(-5).broadcast_to(
        slice_w.shape[:-1] + (1,))
    slice_w = torch.cat([w0, slice_w], dim=-1)              # (*B,N,K,H,W,A)

    cdf = (slice_w * torch.erf(norm_diffs / SQRT2)).sum(-4)  # (*B,N,H,W,A)
    out_rot = torch.erfinv(cdf.clamp(-1 + eps, 1 - eps)) * SQRT2

    if n_axes < c:
        if generator is None:
            raise ValueError('a generator is needed when n_axes < channels')
        tail = torch.randn(out_rot.shape[:-1] + (c - n_axes,),
                           generator=generator, device=out_rot.device,
                           dtype=out_rot.dtype)
        out_rot = torch.cat([out_rot, tail], dim=-1)
    if axis_aligned:
        return out_rot
    return torch.einsum('...nhwd,...hwcd->...nhwc', out_rot, eigvecs)


def gm_samples_to_gaussian_samples(gm: Dict[str, Tensor], gm_samples: Tensor,
                                   n_axes: Optional[int] = None,
                                   eps: float = 1e-6,
                                   generator: Optional[torch.Generator] = None,
                                   axis_aligned: bool = True) -> Tensor:
    """KR transport GM -> standard Gaussian: rotate onto the eigenbasis of
    the mixture's covariance, then per axis apply the conditional 1-D CDF
    and the standard normal inverse CDF. (*B, N, H, W, C) in and out."""
    if 'covs' in gm:
        raise ValueError('KR transport takes isotropic mixtures only')
    c = gm['means'].shape[-1]
    return _kr_to_gaussian(gm, gm_samples, _kr_eigvecs(gm, axis_aligned),
                           c if n_axes is None else n_axes, eps, generator,
                           axis_aligned)


def _kr_to_gm(gm: Dict[str, Tensor], gaussian_samples: Tensor,
              eigvecs: Tensor, n_axes: int, n_steps: int, backward_steps: int,
              eps: float, generator: Optional[torch.Generator],
              axis_aligned: bool) -> Tensor:
    """Standard Gaussian -> GM with the given (*B, 1|H, 1|W, C, C)
    eigenvectors: one ``gm1d_inverse_cdf`` per eigen-axis."""
    means = gm['means']
    c = means.shape[-1]
    ev = eigvecs[..., :n_axes]
    means_rot = torch.einsum('...khwc,...hwcd->...khwd', means, eigvecs)
    samples_rot = gaussian_samples if axis_aligned else torch.einsum(
        '...nhwc,...hwcd->...nhwd', gaussian_samples, ev)

    stds = torch.exp(gm['logstds'])                          # (*B,1,1,1,1)
    logstds_b = gm['logstds'].squeeze(-1)                    # (*B,1,1,1)
    uniform = torch.erf(samples_rot / SQRT2)                 # (*B,N,H,W,A)

    # axis 0 uses the marginal weights; later axes the conditional slice
    # weights from all previous axes, per sample
    lw0 = gm['logweights'].squeeze(-1)                       # (*B,K,H,W)
    out_axes = []
    nd_sq_cum = 0.0
    last = None
    lw_cur = lw0.unsqueeze(-4)                               # (*B,1,K,H,W)
    for axis_id in range(n_axes):
        m_axis = means_rot[..., axis_id]                     # (*B,K,H,W)
        if axis_id > 0:
            prev_m = means_rot[..., axis_id - 1].unsqueeze(-4)
            nd_prev = (last.unsqueeze(-3) - prev_m) \
                / stds.squeeze(-1).unsqueeze(-4)
            nd_sq_cum = nd_sq_cum + nd_prev.square()
            lw_cur = torch.log_softmax(lw0.unsqueeze(-4) - 0.5 * nd_sq_cum,
                                       dim=-3)
        if axis_id == 0:
            gm1d = dict(means=m_axis, logstds=logstds_b, logweights=lw0)
            tgt = uniform[..., axis_id]                      # (*B,N,H,W)
            gs = samples_rot[..., axis_id]
        else:
            # the sample axis folds into the batch, so per-sample
            # conditional weights broadcast
            gm1d = dict(means=m_axis.unsqueeze(-4),
                        logstds=logstds_b.unsqueeze(-4), logweights=lw_cur)
            tgt = uniform[..., axis_id].unsqueeze(-3)        # (*B,N,1,H,W)
            gs = samples_rot[..., axis_id].unsqueeze(-3)
        s = gm1d_inverse_cdf(gm1d, tgt, n_steps=n_steps, eps=eps,
                             max_step_size=1.5, gaussian_samples=gs,
                             backward_steps=backward_steps)
        last = s if axis_id == 0 else s.squeeze(-3)
        out_axes.append(last)
    out_rot = torch.stack(out_axes, dim=-1)                  # (*B,N,H,W,A)

    if n_axes < c:
        if generator is None:
            raise ValueError('a generator is needed when n_axes < channels')
        prev_m = means_rot[..., n_axes - 1].unsqueeze(-4)
        nd_prev = (last.unsqueeze(-3) - prev_m) \
            / stds.squeeze(-1).unsqueeze(-4)
        nd_sq_cum = nd_sq_cum + nd_prev.square()
        lw_tail = torch.log_softmax(lw0.unsqueeze(-4) - 0.5 * nd_sq_cum,
                                    dim=-3)
        # the remaining channels from the conditional mixture: a component
        # per sample, then a Gaussian draw around its mean
        probs = torch.softmax(lw_tail.movedim(-3, -1), dim=-1)  # (*B,N,H,W,K)
        k = means.shape[-4]
        inds = torch.multinomial(probs.reshape(-1, k), 1, generator=generator
                                 ).reshape(probs.shape[:-1])
        one_hot = torch.nn.functional.one_hot(inds, k).to(means.dtype)
        tail_means = torch.einsum('...nhwk,...khwa->...nhwa', one_hot,
                                  means_rot[..., n_axes:])
        noise = torch.randn(tail_means.shape, generator=generator,
                            device=means.device, dtype=tail_means.dtype)
        tail = tail_means + stds.squeeze(-4).unsqueeze(-4) * noise
        out_rot = torch.cat([out_rot, tail], dim=-1)

    return torch.einsum('...nhwd,...hwcd->...nhwc', out_rot, eigvecs)


def gaussian_samples_to_gm_samples(gm: Dict[str, Tensor],
                                   gaussian_samples: Tensor,
                                   n_axes: Optional[int] = None,
                                   n_steps: int = 16, backward_steps: int = 0,
                                   eps: float = 1e-6,
                                   generator: Optional[torch.Generator] = None,
                                   axis_aligned: bool = True) -> Tensor:
    """KR transport standard Gaussian -> GM: per eigen-axis, invert the
    conditional 1-D mixture CDF chain numerically (one K6 launch per axis on
    the card). (*B, N, H, W, C) in and out."""
    if 'covs' in gm:
        raise ValueError('KR transport takes isotropic mixtures only')
    c = gm['means'].shape[-1]
    return _kr_to_gm(gm, gaussian_samples, _kr_eigvecs(gm, axis_aligned),
                     c if n_axes is None else n_axes, n_steps, backward_steps,
                     eps, generator, axis_aligned)
