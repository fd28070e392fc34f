"""The Hopper inverse-CDF kernel (K6) against its plain version, on the
card.

Marked ``cuda``: they skip without a CUDA device (the kernel has no CPU
mode). This file imports no JAX, so it runs where only the port is
installed: ``python -m pytest --noconftest -q
tests/test_torch_inverse_cdf_cuda.py`` (``--noconftest`` because
tests/conftest.py sets up JAX).

Tolerance: kernel and plain version run the same fp32 steps with sums in
another order, so their cdfs differ by a few 1e-7; a root moves by that
over the slope 2 pdf. Each unsaturated element (|target| < 0.999) is held
within 1e-5 + 1e-6 / (2 pdf), pdf taken at the plain version's root;
saturated targets must give finite results. The kernel runs at every
lane count its launcher can choose (``lanes=``), each bitwise repeatable.
"""

import math

import pytest
import torch

from arcflow_tpu_torch.ops.gm import gm_ops
from arcflow_tpu_torch.ops.gm import inverse_cdf as icdf

STEPS = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.Generator(device='cuda').manual_seed(0)


def problem(g, lead, k, n, h, w, logstd=-1.0):
    """A random 1-D mixture (*lead, k, h, w), targets (*lead, n, h, w) from
    standard normal draws, and the isotropic-proxy initial samples."""
    kw = dict(generator=g, device='cuda')
    means = torch.randn(*lead, k, h, w, **kw)
    lw = torch.log_softmax(torch.randn(*lead, k, h, w, **kw), dim=-3)
    logstds = torch.full((*lead, 1, 1, 1), logstd, device='cuda')
    z = torch.randn(*lead, n, h, w, **kw)
    tgt = torch.erf(z / math.sqrt(2))
    wt = lw.exp()
    mean = (wt * means).sum(-3, keepdim=True)
    var = (wt * (means - mean).square()).sum(-3, keepdim=True) \
        + math.exp(2 * logstd)
    return means, lw, wt, logstds, tgt, z * var.sqrt() + mean


def check(args, lanes=None):
    before = icdf.LAUNCHES
    if lanes is None:
        out = icdf.gm1d_inverse_cdf_kernel(*args, n_steps=STEPS)
    else:
        out = icdf.launch(icdf.kernel_geometry(*args), STEPS, 1e-6, 1.5,
                          lanes=lanes)
        again = icdf.launch(icdf.kernel_geometry(*args), STEPS, 1e-6, 1.5,
                            lanes=lanes)
        assert torch.equal(out, again)
        before += 1
    torch.cuda.synchronize()
    assert icdf.LAUNCHES == before + 1
    ref = icdf.gm1d_inverse_cdf_ref(*args, n_steps=STEPS)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    means, lw, _, logstds, tgt, _ = args
    pdf, _ = gm_ops.gm1d_pdf_cdf(dict(means=means, logstds=logstds,
                                      logweights=lw), ref)
    uns = tgt.abs() < 0.999
    err = (out - ref).abs()
    tol = 1e-5 + 1e-6 / (2 * pdf)
    assert not ((err > tol) & uns).any(), (err - tol)[uns].max().item()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('lead,k,n,h,w', [
    ((2,), 4, 5, 3, 3),
    ((1,), 4, 1, 5, 39),                  # M = 195: no multiple of 256
    ((2,), 1, 5, 3, 3),                   # G = 1
    ((1, 1), 16, 1, 128, 128),            # the KR transport's axis, 1024^2
    ((1, 1), 16, 1, 1024, 1024),          # 64 times that
])
def test_kernel_matches_plain_version(cuda, lead, k, n, h, w):
    check(problem(cuda, lead, k, n, h, w))


@pytest.mark.cuda
@pytest.mark.parametrize('lanes', [1, 2, 4, 8, 16])
@pytest.mark.parametrize('k,hw', [(1, (37, 53)), (5, (37, 53)),
                                  (16, (37, 53)), (16, (128, 128))])
def test_every_lane_count(cuda, lanes, k, hw):
    """G = 1, 5 (no multiple of the lanes: empty slots add 0) and 16, on a
    ragged M = 37 x 53 and the KR axis, at each lane count."""
    check(problem(cuda, (1,), k, 2, *hw), lanes=lanes)


@pytest.mark.cuda
@pytest.mark.parametrize('lanes', [1, 4, 16])
def test_per_sample_weights_at_every_lane_count(cuda, lanes):
    """The KR chain's axes after the first: means (B, 1, G, H, W) broadcast
    over the samples, per-sample log-weights (B, N, G, H, W), targets
    (B, N, 1, H, W) strided out of a (B, N, H, W, C) tensor."""
    means, lw, _, logstds, tgt, init = problem(cuda, (2, 1), 16, 1, 12, 9)
    lw = torch.log_softmax(torch.randn(2, 3, 16, 12, 9, generator=cuda,
                                       device='cuda'), dim=-3)
    z = torch.randn(2, 3, 12, 9, 4, generator=cuda, device='cuda')
    tgt = torch.erf(z / math.sqrt(2))[..., 2].unsqueeze(-3)
    init = (z[..., 2] * 0.5).unsqueeze(-3)
    assert not tgt.is_contiguous()
    check((means, lw, lw.exp(), logstds, tgt, init), lanes=lanes)


@pytest.mark.cuda
def test_per_sample_weights_fold_into_the_element_axis(cuda):
    """The KR transport's later axes: means (B, 1, G, H, W), per-sample
    log-weights (B, N, G, H, W), targets (B, N, 1, H, W)."""
    means, lw, _, logstds, tgt, init = problem(cuda, (2, 1), 8, 1, 6, 7)
    lw = torch.log_softmax(torch.randn(2, 5, 8, 6, 7, generator=cuda,
                                       device='cuda'), dim=-3)
    tgt, init = (x.expand(2, 5, 1, 6, 7).contiguous() for x in (tgt, init))
    check((means, lw, lw.exp(), logstds, tgt, init))


@pytest.mark.cuda
def test_saturated_targets_and_determinism(cuda):
    """Targets at and next to +-1 stay finite; two runs are bitwise
    equal."""
    args = list(problem(cuda, (1,), 16, 2, 64, 64))
    tgt = args[4].clone()
    tgt[0, 0, :4] = 1.0
    tgt[0, 1, :4] = -1.0
    tgt[0, 0, 4:8] = 1 - 1e-7
    args[4] = tgt
    out = check(args)
    again = icdf.gm1d_inverse_cdf_kernel(*args, n_steps=STEPS)
    assert torch.equal(out, again)
    for lanes in (1, 2, 4, 8, 16):
        check(args, lanes=lanes)


@pytest.mark.cuda
def test_gm1d_inverse_cdf_and_kr_launch_the_kernel(cuda):
    """``gm1d_inverse_cdf`` launches once for its no-grad steps (and stays
    differentiable after them); the KR transport once per channel axis and
    agrees with its plain path."""
    means, lw, _, logstds, tgt, _ = problem(cuda, (2,), 4, 3, 5, 5)
    means.requires_grad_()
    before = icdf.LAUNCHES
    s = gm_ops.gm1d_inverse_cdf(dict(means=means, logstds=logstds,
                                     logweights=lw), tgt, n_steps=10,
                                backward_steps=2)
    s.sum().backward()
    assert icdf.LAUNCHES == before + 1
    assert torch.isfinite(means.grad).all() and means.grad.any()

    gm = dict(means=torch.randn(1, 16, 8, 8, 3, generator=cuda,
                                device='cuda'),
              logstds=torch.full((1, 1, 1, 1, 1), -1.0, device='cuda'),
              logweights=torch.log_softmax(torch.randn(
                  1, 16, 8, 8, 1, generator=cuda, device='cuda'), dim=1))
    z = torch.randn(1, 2, 8, 8, 3, generator=cuda, device='cuda')
    before = icdf.LAUNCHES
    x = gm_ops.gaussian_samples_to_gm_samples(gm, z)
    assert icdf.LAUNCHES == before + 3
    real = icdf.gm1d_inverse_cdf_kernel
    try:
        icdf.gm1d_inverse_cdf_kernel = icdf.gm1d_inverse_cdf_ref
        x_plain = gm_ops.gaussian_samples_to_gm_samples(gm, z)
    finally:
        icdf.gm1d_inverse_cdf_kernel = real
    uns = (torch.erf(z / math.sqrt(2)).abs() < 0.999).all(-1)
    assert ((x - x_plain).norm(dim=-1)[uns].max() < 1e-3)
    z_rec = gm_ops.gm_samples_to_gaussian_samples(gm, x)
    assert (z_rec - z).abs().amax(-1)[uns].max() < 1e-3


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    means, lw, wt, logstds, tgt, init = problem(cuda, (), 2, 1, 1, 1)
    many = problem(cuda, (), 257, 1, 1, 1)
    with pytest.raises(ValueError, match='G=257'):
        icdf.gm1d_inverse_cdf_kernel(*many)
    with pytest.raises(ValueError, match='on one card'):
        icdf.gm1d_inverse_cdf_kernel(means.cpu(), lw, wt, logstds, tgt, init)
    geom = icdf.kernel_geometry(means, lw, wt, logstds, tgt, init)
    geom['inputs'][0] = geom['inputs'][0].double()
    with pytest.raises(ValueError, match='fp32'):
        icdf.launch(geom, STEPS, 1e-6, 1.5)
    # more targets than a grid's y axis took before: one element axis now
    check((means, lw, wt, logstds, tgt.expand(65536, 1, 1).contiguous(),
           init.expand(65536, 1, 1).contiguous()))
