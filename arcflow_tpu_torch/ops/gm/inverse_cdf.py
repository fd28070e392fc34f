"""Newton-Raphson inversion of a 1-D Gaussian-mixture CDF: the Hopper
kernel, its wrapper and its plain PyTorch version.

The kernel (``csrc/gm_inverse_cdf.cu``) replaces the JAX package's TPU
kernel ``arcflow_tpu/ops/gm/inverse_cdf.py:gm1d_inverse_cdf_pallas``: each
element runs ``n_steps`` clamped NR steps on the mixture CDF scaled to
[-1, 1]. Shapes follow ``gm_ops.gm1d_*``: means, log-weights and weights
(..., G, H, W) broadcastable against targets and initial samples
(..., N, H, W). The kernel reads every input in place, as a broadcast view
over the element axes (lead..., N, H, W) with the axes merged where all
tensors allow (``kernel_geometry``), and writes the (lead..., N, H, W)
result; it runs L lanes per element (``lanes_for``). The plain version
lays everything out as (rows, M) with M = prod(batch, H, W), as the JAX
``to_gm_layout`` does (``kernel_layout``). A CUDA tensor always launches
the kernel (or the wrapper raises); only a CPU tensor takes
``gm1d_inverse_cdf_ref``.

The kernel's erf is the TPU kernel's Abramowitz-Stegun 7.1.26 (|err| <
1.5e-7) and the plain version's is ``torch.erf``, so the two cdfs differ
by up to 1.5e-7 and the roots by that over 2 pdf.
"""

from __future__ import annotations

import ctypes
import math

import torch

# Kernel launches since the count was last set to 0; the wrapper adds one
# per launch and nothing else touches it except a caller resetting it.
LAUNCHES = 0

# The kernel's limits (csrc/gm_inverse_cdf.cu): element dimensions after
# merging, lanes per element and component slots per lane (powers of two).
MAX_DIMS = 6
MAX_LANES = 16
MAX_PER_LANE = 16
# lanes double while the grid holds fewer threads than this: about four
# warps for each of the 4 x 132 warp schedulers of an H100. More lanes only
# add shuffles: at the KR axis (16,384 elements, G 16) the kernel ran
# fastest at 4 lanes, 65,536 threads (attention_ab.py, PERF.md)
FILL_THREADS = 65536

INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _broadcast(a, b):
    """The broadcast of two shapes (``torch.broadcast_shapes`` without its
    cost on the host)."""
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)
    out = []
    for x, y in zip(a, b):
        if x != y and 1 not in (x, y):
            raise ValueError(f'shapes {a} and {b} do not broadcast')
        out.append(y if x == 1 else x)
    return tuple(out)


def _layout(means, scaled_cdfs):
    """(lead, H, W, M) of the broadcast element axis."""
    batch_hw = _broadcast(means.shape[:-3] + means.shape[-2:],
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


def _pow2_at_least(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def lanes_for(g: int, elements: int) -> int:
    """Lanes per element: doubled from 1 while the grid (elements x lanes
    threads) holds fewer than ``FILL_THREADS`` and the lanes have
    components to share, up to 16; then at least enough that a lane holds
    no more than ``MAX_PER_LANE`` components."""
    lanes = 1
    while (lanes < MAX_LANES and lanes < g
           and elements * lanes < FILL_THREADS):
        lanes *= 2
    while lanes < MAX_LANES and -(-g // lanes) > MAX_PER_LANE:
        lanes *= 2
    return lanes


def merge_dims(sizes, strides):
    """Drop the size-1 axes of an element space and merge each axis into
    the next inner one where every tensor's strides allow it (outer stride
    = inner stride x inner size). ``strides`` holds one stride tuple per
    tensor; returns (sizes, strides) of the merged axes, outer first, at
    least one axis."""
    axes = [(n, [st[i] for st in strides]) for i, n in enumerate(sizes)
            if n != 1]
    merged = []
    for n, st in axes:
        if merged and all(o == i * n for o, i in zip(merged[-1][1], st)):
            merged[-1] = (merged[-1][0] * n, st)
        else:
            merged.append((n, st))
    if not merged:
        merged = [(1, [0] * len(strides))]
    return [n for n, _ in merged], [[st[k] for _, st in merged]
                                    for k in range(len(strides))]


def _aligned_strides(sizes, strides, shape):
    """The strides of a tensor of ``sizes`` and ``strides`` broadcast to
    ``shape`` (axes aligned to the right; a broadcast axis has stride 0),
    as ``broadcast_to`` would give them, computed without a view."""
    pad = len(shape) - len(sizes)
    if pad < 0:
        raise ValueError(f'cannot broadcast {tuple(sizes)} to {shape}')
    out = [0] * pad
    for n, m, st in zip(shape[pad:], sizes, strides):
        if m not in (1, n):
            raise ValueError(f'cannot broadcast {tuple(sizes)} to {shape}')
        out.append(st if m == n and n != 1 else 0)
    return out


def kernel_geometry(means, logweights, weights, logstds, scaled_cdfs,
                    init_samples):
    """What the kernel reads, with no copy: the six inputs in fp32 as they
    lie, a fresh (*lead, N, H, W) fp32 output, and the merged element axes
    (*lead, N, H, W): ``sizes``, the element ``strides`` of the six inputs
    (broadcast axes 0) and the output, and the component strides
    ``gstrides`` of means, log-weights and weights. Only a tensor not in
    fp32 is converted."""
    lead, h, w, _ = _layout(means, scaled_cdfs)
    g, n = means.shape[-3], scaled_cdfs.shape[-3]
    elem = lead + (n, h, w)
    inputs = [x if x.dtype == torch.float32 else x.to(torch.float32)
              for x in (means, logweights, weights, logstds, scaled_cdfs,
                        init_samples)]
    strides, gstrides = [], []
    for x in inputs[:4]:
        # (..., rows, H, W) over (*lead, N, rows, H, W): a unit axis for N,
        # and the rows axis leaves the element axes
        size, stride = x.shape, x.stride()
        st = _aligned_strides(size[:-3] + (1,) + size[-3:],
                              stride[:-3] + (0,) + stride[-3:],
                              lead + (n, size[-3], h, w))
        strides.append(st[:-3] + st[-2:])
        gstrides.append(st[-3])
    strides += [_aligned_strides(x.shape, x.stride(), elem)
                for x in inputs[4:]]
    out = torch.empty(elem, dtype=torch.float32, device=scaled_cdfs.device)
    sizes, strides = merge_dims(elem, strides + [list(out.stride())])
    return dict(inputs=inputs, out=out, sizes=sizes, strides=strides,
                gstrides=gstrides[:3], g=g, elements=math.prod(elem))


def launch(geom, n_steps: int, eps: float, max_step_size: float,
           lanes=None) -> torch.Tensor:
    """One kernel launch on a ``kernel_geometry``, at ``lanes`` lanes per
    element (default ``lanes_for``): fills and returns its output and
    counts the launch."""
    inputs, out, g = geom['inputs'], geom['out'], geom['g']
    dev = out.device
    for t in inputs:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError('the kernel takes fp32 tensors on one card')
    if len(geom['sizes']) > MAX_DIMS:
        raise ValueError(f'the element axes merge into '
                         f'{len(geom["sizes"])} dims; the kernel indexes '
                         f'at most {MAX_DIMS}')
    elements = geom['elements']
    lanes = lanes_for(g, elements) if lanes is None else lanes
    per_lane = _pow2_at_least(-(-g // lanes))
    if (g < 1 or lanes not in (1, 2, 4, 8, 16) or per_lane > MAX_PER_LANE
            or not 1 <= elements < 2 ** 31):
        raise ValueError(f'unsupported inverse-CDF problem G={g} '
                         f'elements={elements} at {lanes} lanes')
    from .._build import load_library
    lib = load_library()
    vals = [*geom['sizes'], *(s for st in geom['strides'] for s in st),
            *geom['gstrides']]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.arcflow_gm_inverse_cdf(
        *(t.data_ptr() for t in inputs), out.data_ptr(),
        (ctypes.c_longlong * len(vals))(*vals), len(geom['sizes']), g,
        elements, n_steps, eps, max_step_size, lanes, per_lane, stream)
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
    tensors go to ``gm1d_inverse_cdf_ref``; any other device, an empty
    problem, G > 256, or element axes that merge into more than 6 raise."""
    dev = scaled_cdfs.device
    if dev.type == 'cpu':
        return gm1d_inverse_cdf_ref(means, logweights, weights, logstds,
                                    scaled_cdfs, init_samples, n_steps, eps,
                                    max_step_size)
    if dev.type != 'cuda':
        raise ValueError(f'no inverse-CDF kernel for device {dev}')
    out = launch(kernel_geometry(means, logweights, weights, logstds,
                                 scaled_cdfs, init_samples),
                 n_steps, eps, max_step_size)
    return out.to(scaled_cdfs.dtype)
