"""Newton-Raphson inversion of a 1-D Gaussian-mixture CDF: the Hopper
kernel, its wrapper and its plain PyTorch version.

The kernel (``csrc/gm_inverse_cdf.cu``) replaces the JAX package's TPU
kernel ``arcflow_tpu/ops/gm/inverse_cdf.py:gm1d_inverse_cdf_pallas``: each
element runs ``n_steps`` clamped NR steps on the mixture CDF scaled to
[-1, 1]. Shapes follow ``gm_ops.gm1d_*``: means, log-weights and weights
(..., G, H, W) broadcastable against targets and initial samples
(..., N, H, W); the wrapper broadcasts the leading axes and lays everything
out as (rows, M) with M = prod(batch, H, W) contiguous, as the JAX
``to_gm_layout`` does. A CUDA tensor always launches the kernel (or the
wrapper raises); only a CPU tensor takes ``gm1d_inverse_cdf_ref``.

The kernel's erf is CUDA's ``erff``; the TPU kernel's is Abramowitz-Stegun
7.1.26 (|err| < 1.5e-7), so the two cdfs differ by up to 1.5e-7 per
component weight and the roots by that over 2 pdf.
"""

from __future__ import annotations

import math

import torch

# Kernel launches since the count was last set to 0; the wrapper adds one
# per launch and nothing else touches it except a caller resetting it.
LAUNCHES = 0

INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _layout(means, scaled_cdfs):
    """(lead, H, W, M) of the broadcast element axis."""
    batch_hw = torch.broadcast_shapes(
        means.shape[:-3] + means.shape[-2:],
        scaled_cdfs.shape[:-3] + scaled_cdfs.shape[-2:])
    lead, (h, w) = tuple(batch_hw[:-2]), batch_hw[-2:]
    return lead, h, w, math.prod(lead) * h * w


def _to_rows(x, lead, rows, h, w, m):
    """(..., rows, H, W) broadcast to (*lead, rows, H, W) -> contiguous fp32
    (rows, M), M ordered as (*lead, H, W)."""
    x = x.to(torch.float32).broadcast_to(lead + (rows, h, w))
    return x.movedim(-3, 0).reshape(rows, m).contiguous()


def _from_rows(out, lead, h, w):
    """(N, M) -> (*lead, N, H, W)."""
    return out.reshape(out.shape[0], *lead, h, w).movedim(0, -3)


def nr_steps_ref(means, logw, w, logstd, target, init, n_steps, eps,
              max_step_size):
    """The kernel's arithmetic on the (rows, M) layout, in fp32."""
    inv_std = torch.exp(-logstd)                               # (1, M)
    clamp = max_step_size * torch.exp(logstd)
    s = init
    for _ in range(n_steps):
        nd = (s[:, None, :] - means[None]) * inv_std[None]     # (N, G, M)
        pdf = torch.exp(-0.5 * nd.square() - logstd[None]
                        + logw[None]).sum(1) * INV_SQRT_2PI
        cdf = (w[None] * torch.erf(nd * INV_SQRT2)).sum(1)
        delta = 0.5 * (cdf - target) / pdf.clamp_min(eps)
        s = s - torch.clamp(delta, -clamp, clamp)
    return s


def kernel_layout(means, logweights, weights, logstds, scaled_cdfs,
                  init_samples):
    """The six inputs as contiguous fp32 (rows, M) tensors, and (lead, H,
    W) to bring an (N, M) result back with ``_from_rows``."""
    lead, h, w, m = _layout(means, scaled_cdfs)
    g, n = means.shape[-3], scaled_cdfs.shape[-3]
    rows = [_to_rows(x, lead, r, h, w, m) for x, r in (
        (means, g), (logweights, g), (weights, g), (logstds, 1),
        (scaled_cdfs, n), (init_samples, n))]
    return rows, (lead, h, w)


def gm1d_inverse_cdf_ref(means, logweights, weights, logstds, scaled_cdfs,
                         init_samples, n_steps: int = 8, eps: float = 1e-6,
                         max_step_size: float = 1.5) -> torch.Tensor:
    """The plain version: the kernel's steps in PyTorch on the same layout.
    Returns (..., N, H, W) in ``scaled_cdfs``' dtype."""
    rows, (lead, h, w) = kernel_layout(means, logweights, weights, logstds,
                                       scaled_cdfs, init_samples)
    out = nr_steps_ref(*rows, n_steps, eps, max_step_size)
    return _from_rows(out, lead, h, w).to(scaled_cdfs.dtype)


def launch(rows, n_steps: int, eps: float, max_step_size: float
           ) -> torch.Tensor:
    """One kernel launch on the (rows, M) layout of ``kernel_layout``
    (means, logw, w (G, M), logstd (1, M), target, init (N, M), contiguous
    fp32 on one card): returns the fresh (N, M) result and counts the
    launch."""
    means, _, _, _, target, _ = rows
    dev = target.device
    for t in rows:
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or t.dim() != 2
                or t.shape[1] != means.shape[1]):
            raise ValueError('the kernel takes contiguous fp32 (rows, M) '
                             'tensors on one card')
    g, n, m = means.shape[0], target.shape[0], means.shape[1]
    if g == 0 or m == 0 or not 1 <= n <= 65535:
        raise ValueError(f'unsupported inverse-CDF problem G={g} N={n} M={m}')
    from .._build import load_library
    lib = load_library()
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.arcflow_gm_inverse_cdf(
        *(t.data_ptr() for t in rows), out.data_ptr(), g, n, m, n_steps,
        eps, max_step_size, stream)
    if err != 0:
        raise RuntimeError('inverse-CDF kernel launch failed: '
                           + lib.arcflow_cuda_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    return out


def gm1d_inverse_cdf_kernel(means, logweights, weights, logstds, scaled_cdfs,
                            init_samples, n_steps: int = 8, eps: float = 1e-6,
                            max_step_size: float = 1.5) -> torch.Tensor:
    """``n_steps`` NR steps from ``init_samples`` toward the roots of
    cdf(s) = ``scaled_cdfs``: the Hopper kernel on CUDA tensors, one launch
    per call. Not differentiable (the caller runs it under no_grad). CPU
    tensors go to ``gm1d_inverse_cdf_ref``; any other device, N > 65535 or
    an empty problem raises."""
    dev = scaled_cdfs.device
    if dev.type == 'cpu':
        return gm1d_inverse_cdf_ref(means, logweights, weights, logstds,
                                    scaled_cdfs, init_samples, n_steps, eps,
                                    max_step_size)
    if dev.type != 'cuda':
        raise ValueError(f'no inverse-CDF kernel for device {dev}')
    rows, (lead, h, w) = kernel_layout(means, logweights, weights, logstds,
                                       scaled_cdfs, init_samples)
    out = launch(rows, n_steps, eps, max_step_size)
    return _from_rows(out, lead, h, w).to(scaled_cdfs.dtype)
