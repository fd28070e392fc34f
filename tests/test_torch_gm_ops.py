"""Port parity: the Gaussian-mixture library (arcflow_tpu_torch.ops.gm)
against the JAX package's ``arcflow_tpu.ops.gm``.

Inputs come from numpy with a seed and go through both. Tolerances: the
closed forms (moments, iso products, log-probs, pdf/cdf) in fp32 against
fp32 differ only in the order of their sums, rtol 1e-5 and atol 1e-6; the
forms built on inverse, solve, Cholesky, slogdet or eigh, atol 1e-4. The
Newton-Raphson inverse CDF and the KR transport are compared where the
per-axis target satisfies |cdf| < 0.999, as tests/test_gm_ops.py does,
because the inversion is ill-conditioned where the CDF saturates; the KR
parity passes JAX's eigenvectors into the port's transport core, since each
eigenvector's sign is up to the library and the map is not invariant to it.
Random draws (``gm_to_sample``, KL, entropy) differ between jax.random and
torch.Generator, so those are compared by moments.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.ops.gm import gm_ops as j_gm
from arcflow_tpu_torch.ops.gm import gm_ops as t_gm
from arcflow_tpu_torch.ops.gm import inverse_cdf as t_icdf

torch.set_num_threads(1)

CLOSED = dict(rtol=1e-5, atol=1e-6)
LINALG = dict(rtol=0, atol=1e-4)


def make_gm(seed, b=2, k=4, h=3, w=3, c=2, logstd=-0.5):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((b, k, h, w, c)).astype(np.float32)
    logits = rng.standard_normal((b, k, h, w, 1)).astype(np.float32)
    logweights = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    return dict(means=means, logstds=np.full((b, 1, 1, 1, 1), logstd,
                                             np.float32),
                logweights=logweights.astype(np.float32))


def gaussian(seed, b=2, h=3, w=3, c=2, full=False):
    rng = np.random.default_rng(seed)
    g = dict(mean=rng.standard_normal((b, h, w, c)).astype(np.float32))
    if full:
        a = rng.standard_normal((b, h, w, c, c)).astype(np.float32)
        g['cov'] = (a @ a.swapaxes(-1, -2) * 0.3
                    + 0.5 * np.eye(c, dtype=np.float32))
    else:
        g['var'] = (0.2 + rng.random((b, h, w, 1))).astype(np.float32)
    return g


def jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def th(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def close(got, want, tol=CLOSED):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---- closed forms -------------------------------------------------------------

@pytest.mark.parametrize('power', [1.0, 2.5])
def test_gm_to_mean(power):
    gm = make_gm(0)
    close(t_gm.gm_to_mean(th(gm), power), j_gm.gm_to_mean(jx(gm), power))


def test_gm_to_iso_and_full_gaussian():
    gm = make_gm(1, c=3)
    for fn in ('gm_to_iso_gaussian', 'gm_to_gaussian'):
        got, got_d = getattr(t_gm, fn)(th(gm))
        want, want_d = getattr(j_gm, fn)(jx(gm))
        close(got, want)
        close(got_d, want_d)


def test_moments_of_a_full_covariance_gm():
    """The ``covs`` branches, on the output of gm_mul_gaussian."""
    gm, g = make_gm(2, c=3), gaussian(3, c=3, full=True)
    j_out = j_gm.gm_mul_gaussian(jx(gm), jx(g))[0]
    t_out = t_gm.gm_mul_gaussian(th(gm), th(g))[0]
    close(t_out, j_out, LINALG)
    for fn in ('gm_to_iso_gaussian', 'gm_to_gaussian'):
        close(getattr(t_gm, fn)(t_out)[0], getattr(j_gm, fn)(j_out)[0],
              LINALG)


@pytest.mark.parametrize('p1,p2', [(1.0, 1.0), (1.0, -1.0), (0.7, 2.0)])
def test_iso_gaussian_products(p1, p2):
    g1, g2 = gaussian(4), gaussian(5)
    g2['var'] = g2['var'] + 2.0           # keeps power1 var2 + power2 var1 > 0
    close(t_gm.iso_gaussian_mul_iso_gaussian(th(g1), th(g2), p1, p2),
          j_gm.iso_gaussian_mul_iso_gaussian(jx(g1), jx(g2), p1, p2))


@pytest.mark.parametrize('with_logstd', [False, True])
@pytest.mark.parametrize('gm_power,g_power', [(1.0, 1.0), (2.0, 0.5)])
def test_gm_mul_iso_gaussian(with_logstd, gm_power, g_power):
    gm, g = make_gm(6), gaussian(7)
    if with_logstd:
        g['logstd'] = 0.5 * np.log(g['var'])
    got, gp = t_gm.gm_mul_iso_gaussian(th(gm), th(g), gm_power, g_power)
    want, _ = j_gm.gm_mul_iso_gaussian(jx(gm), jx(g), gm_power, g_power)
    assert gp == gm_power
    close(got, want)


def test_gm_mul_gm():
    gm1, gm2 = make_gm(8, k=2), make_gm(9, k=3, logstd=-0.2)
    close(t_gm.gm_mul_gm(th(gm1), th(gm2)), j_gm.gm_mul_gm(jx(gm1), jx(gm2)))


def test_gaussian_mul_gaussian():
    g1, g2 = gaussian(10, full=True), gaussian(11, full=True)
    close(t_gm.gaussian_mul_gaussian(th(g1), th(g2), 1.0, 0.5),
          j_gm.gaussian_mul_gaussian(jx(g1), jx(g2), 1.0, 0.5), LINALG)


def test_log_probs():
    gm, g = make_gm(12), gaussian(13)
    x = np.random.default_rng(14).standard_normal((2, 5, 3, 3, 2)).astype(
        np.float32)
    close(t_gm.iso_gaussian_logprob(th(g), torch.from_numpy(x)),
          j_gm.iso_gaussian_logprob(jx(g), jnp.asarray(x)))
    for got, want in zip(t_gm.gm_logprob(th(gm), torch.from_numpy(x)),
                         j_gm.gm_logprob(jx(gm), jnp.asarray(x))):
        close(got, want)


def test_log_probs_of_a_full_covariance_gm():
    gm, g = make_gm(15, c=3), gaussian(16, c=3, full=True)
    x = np.random.default_rng(17).standard_normal((2, 4, 3, 3, 3)).astype(
        np.float32)
    t_out = t_gm.gm_mul_gaussian(th(gm), th(g))[0]
    j_out = j_gm.gm_mul_gaussian(jx(gm), jx(g))[0]
    for got, want in zip(t_gm.gm_logprob(t_out, torch.from_numpy(x)),
                         j_gm.gm_logprob(j_out, jnp.asarray(x))):
        close(got, want, LINALG)


@pytest.mark.parametrize('mode', ['none', 'given', 'kr'])
def test_spectral_logprobs(mode):
    """Without a spectrum, with given spectral samples, and with the KR
    residuals (invariant to the eigenvectors' signs: an axis's sign flip
    flips re + im of its FFT, which enters squared)."""
    gm = make_gm(18, b=1, h=4, w=4, c=2)
    rng = np.random.default_rng(19)
    x = rng.standard_normal((1, 3, 4, 4, 2)).astype(np.float32)
    kw_t, kw_j = {}, {}
    if mode != 'none':
        ps = (0.3 * rng.standard_normal((1, 4, 4, 1))).astype(np.float32)
        kw_t['power_spectrum'] = torch.from_numpy(ps)
        kw_j['power_spectrum'] = jnp.asarray(ps)
    if mode == 'given':
        ss = rng.standard_normal((1, 3, 4, 4, 2)).astype(np.float32)
        kw_t['spectral_samples'] = torch.from_numpy(ss)
        kw_j['spectral_samples'] = jnp.asarray(ss)
    close(t_gm.gm_spectral_logprobs(th(gm), torch.from_numpy(x), **kw_t),
          j_gm.gm_spectral_logprobs(jx(gm), jnp.asarray(x), **kw_j),
          CLOSED if mode != 'kr' else LINALG)


@pytest.mark.parametrize('temperature', [0.2, 1.0, 3.0])
def test_temperature(temperature):
    gm = make_gm(20)
    gm['gm_vars'] = np.exp(2 * gm['logstds'])
    close(t_gm.gm_temperature(th(gm), temperature),
          j_gm.gm_temperature(jx(gm), temperature))


def test_transpose_t_first_swaps_components_and_time():
    """(B, K, T, H, W, C) -> (B, T, K, H, W, C). Divergence, named: the JAX
    function moves axis -5 to -5 and returns every tensor unchanged; the
    port does what both docstrings say."""
    rng = np.random.default_rng(21)
    gm = dict(means=rng.standard_normal((2, 3, 4, 2, 2, 2)),
              logweights=rng.standard_normal((2, 3, 4, 2, 2, 1)),
              logstds=np.zeros((2, 1, 1, 1, 1)))
    gm = {k: v.astype(np.float32) for k, v in gm.items()}
    got = t_gm.gm_transpose_t_first(th(gm))
    np.testing.assert_array_equal(got['means'].numpy(),
                                  gm['means'].transpose(0, 2, 1, 3, 4, 5))
    np.testing.assert_array_equal(got['logweights'].numpy(),
                                  gm['logweights'].transpose(0, 2, 1, 3, 4, 5))
    np.testing.assert_array_equal(got['logstds'].numpy(), gm['logstds'])
    want = j_gm.gm_transpose_t_first(jx(gm))
    np.testing.assert_array_equal(np.asarray(want['means']), gm['means'])


# ---- 1-D inverse CDF ------------------------------------------------------------

def gm1d_problem(seed, b=2, g=4, h=3, w=3, n=5):
    rng = np.random.default_rng(seed)
    means = (2 * rng.standard_normal((b, g, h, w))).astype(np.float32)
    logits = rng.standard_normal((b, g, h, w)).astype(np.float32)
    lw = (logits - np.log(np.exp(logits).sum(1, keepdims=True))).astype(
        np.float32)
    gm1d = dict(means=means, logstds=np.full((b, 1, 1, 1), -0.3, np.float32),
                logweights=lw)
    x_true = (1.5 * rng.standard_normal((b, n, h, w))).astype(np.float32)
    _, cdf = j_gm.gm1d_pdf_cdf(jx(gm1d), jnp.asarray(x_true))
    return gm1d, np.array(cdf), x_true


def assert_roots_close(got, want, gm1d, cdf, atol=1e-5):
    """Roots agree within ``atol`` plus what fp32 rounding of the scaled
    cdf (a few 1e-7 over G terms; taken as 1e-6) moves a root by: that over
    the slope 2 pdf. Compared where |cdf| < 0.999."""
    pdf, _ = j_gm.gm1d_pdf_cdf(jx(gm1d), jnp.asarray(want))
    mask = np.abs(cdf) < 0.999
    assert mask.mean() > 0.8
    tol = atol + 1e-6 / (2 * np.asarray(pdf))
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= tol)[mask].all(), (err - tol)[mask].max()


def test_gm1d_pdf_cdf():
    gm1d, _, x = gm1d_problem(22)
    for got, want in zip(t_gm.gm1d_pdf_cdf(th(gm1d), torch.from_numpy(x)),
                         j_gm.gm1d_pdf_cdf(jx(gm1d), jnp.asarray(x))):
        close(got, want)


@pytest.mark.parametrize('backward_steps', [0, 2])
def test_gm1d_inverse_cdf_values(backward_steps):
    """Values against the jnp path (``use_pallas=False``), atol 1e-5 plus
    the rounding term of ``assert_roots_close``, where |cdf| < 0.999; the
    port's no-grad tier is the kernel's plain version on CPU tensors."""
    gm1d, cdf, x_true = gm1d_problem(23)
    want = j_gm.gm1d_inverse_cdf(jx(gm1d), jnp.asarray(cdf), n_steps=16,
                                 backward_steps=backward_steps,
                                 use_pallas=False)
    got = t_gm.gm1d_inverse_cdf(th(gm1d), torch.from_numpy(cdf), n_steps=16,
                                backward_steps=backward_steps)
    assert_roots_close(got.detach().numpy(), want, gm1d, cdf)
    mask = np.abs(cdf) < 0.999
    assert np.abs(got.detach().numpy() - x_true)[mask].max() < 2e-3


def test_gm1d_inverse_cdf_grads_match_jax_grad():
    """Gradients with respect to means, log-weights and logstds through the
    differentiable tier (backward_steps 2): rtol 1e-4, atol 1e-5. The loss
    weights keep the targets whose root is well conditioned (|cdf| < 0.999
    and pdf > 1e-2): elsewhere fp32 rounding moves the root itself (see
    ``assert_roots_close``) and its derivative with it."""
    gm1d, cdf, x_true = gm1d_problem(24)
    rng = np.random.default_rng(25)
    pdf, _ = j_gm.gm1d_pdf_cdf(jx(gm1d), jnp.asarray(x_true))
    keep = (np.abs(cdf) < 0.999) & (np.asarray(pdf) > 1e-2)
    assert keep.mean() > 0.5
    r = (rng.standard_normal(cdf.shape) * keep).astype(np.float32)

    def j_loss(means, logweights, logstds):
        s = j_gm.gm1d_inverse_cdf(
            dict(means=means, logweights=logweights, logstds=logstds),
            jnp.asarray(cdf), n_steps=10, backward_steps=2, use_pallas=False)
        return (s * r).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(gm1d['means']), jnp.asarray(gm1d['logweights']),
        jnp.asarray(gm1d['logstds']))
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in gm1d.items()}
    s = t_gm.gm1d_inverse_cdf(leaves, torch.from_numpy(cdf), n_steps=10,
                              backward_steps=2)
    (s * torch.from_numpy(r)).sum().backward()
    for name, w in zip(('means', 'logweights', 'logstds'), want):
        np.testing.assert_allclose(leaves[name].grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_backward_tier_runs_n_steps_not_backward_steps():
    """n_steps 3 with backward_steps 2 runs 1 kernel step and then 3
    differentiable steps, 4 in all (JAX gm_ops.py:454-456), not 3: the
    result equals 4 plain steps and not 3. Few steps from a far start keep
    the iterates apart. The JAX function counts its steps the same way."""
    gm1d, cdf, _ = gm1d_problem(26)
    gm = th(gm1d)
    t = torch.from_numpy(cdf)
    init = torch.zeros_like(t)              # the mixture mean
    got = t_gm.gm1d_inverse_cdf(gm, t, n_steps=3, backward_steps=2,
                                gaussian_samples=init)

    def plain(steps):
        return t_gm.gm1d_inverse_cdf(gm, t, n_steps=steps, backward_steps=0,
                                     gaussian_samples=init)
    np.testing.assert_allclose(got.detach().numpy(), plain(4).numpy(),
                               atol=1e-5)
    assert np.abs(got.detach().numpy() - plain(3).numpy()).max() > 1e-2
    def j_run(steps, bwd):
        return np.asarray(j_gm.gm1d_inverse_cdf(
            jx(gm1d), jnp.asarray(cdf), n_steps=steps, backward_steps=bwd,
            use_pallas=False, gaussian_samples=jnp.asarray(init.numpy())))
    # its fori_loop and unrolled steps round apart by up to a few 1e-5
    np.testing.assert_allclose(j_run(3, 2), j_run(4, 0), atol=1e-4)


def test_no_grad_tier_goes_through_the_kernel_wrapper(monkeypatch):
    """The first n_steps - backward_steps steps are one wrapper call with
    that many steps; its output is detached."""
    gm1d, cdf, _ = gm1d_problem(27)
    calls = []
    real = t_icdf.gm1d_inverse_cdf_kernel

    def spy(*args, **kwargs):
        calls.append(kwargs['n_steps'])
        assert not torch.is_grad_enabled()
        return real(*args, **kwargs)
    monkeypatch.setattr(t_icdf, 'gm1d_inverse_cdf_kernel', spy)
    means = torch.from_numpy(gm1d['means']).requires_grad_()
    gm = dict(th(gm1d), means=means)
    out = t_gm.gm1d_inverse_cdf(gm, torch.from_numpy(cdf), n_steps=12,
                                backward_steps=0)
    assert calls == [12] and not out.requires_grad
    t_gm.gm1d_inverse_cdf(gm, torch.from_numpy(cdf), n_steps=12,
                          backward_steps=5)
    assert calls == [12, 7]


# ---- Knothe-Rosenblatt transport --------------------------------------------------

def _j_eigvecs(gm, axis_aligned):
    return torch.from_numpy(np.asarray(
        j_gm._kr_eigvecs(jx(gm), axis_aligned)).copy())


@pytest.mark.parametrize('axis_aligned', [True, False])
@pytest.mark.parametrize('n_axes', [None, 2])
def test_kr_gaussian_to_gm_matches_jax(axis_aligned, n_axes):
    """The port's transport core with JAX's eigenvectors, atol 1e-4 where
    every axis's target has |cdf| < 0.999; with n_axes < C the remaining
    channels are random draws, so only the first n_axes rotated channels
    are compared."""
    gm = make_gm(28, b=2, k=4, h=3, w=3, c=3, logstd=-0.4)
    z = np.random.default_rng(29).standard_normal((2, 4, 3, 3, 3)).astype(
        np.float32)
    ev = _j_eigvecs(gm, axis_aligned)
    want = j_gm.gaussian_samples_to_gm_samples(
        jx(gm), jnp.asarray(z), n_axes=n_axes, n_steps=16,
        rng=jax.random.PRNGKey(0), axis_aligned=axis_aligned,
        use_pallas=False)
    a = 3 if n_axes is None else n_axes
    got = t_gm._kr_to_gm(th(gm), torch.from_numpy(z), ev, a, 16, 0, 1e-6,
                         torch.Generator().manual_seed(0), axis_aligned)
    want, got = np.asarray(want), got.numpy()
    # per-axis targets: erf of the (rotated) Gaussian draws
    z_rot = z if axis_aligned else np.einsum('bnhwc,bhwcd->bnhwd', z,
                                             ev.numpy())
    ok = (np.abs([math.erf(v / math.sqrt(2)) for v in z_rot[..., :a].ravel()])
          .reshape(z_rot[..., :a].shape) < 0.999).all(-1)
    assert ok.mean() > 0.9
    if n_axes is not None:       # compare in the eigenbasis
        evn = np.broadcast_to(ev.numpy()[:, None], (2, 1) + ev.shape[1:])
        want = np.einsum('bnhwc,bnhwcd->bnhwd', want, evn)[..., :a]
        got = np.einsum('bnhwc,bnhwcd->bnhwd', got, evn)[..., :a]
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-4)


@pytest.mark.parametrize('axis_aligned', [True, False])
@pytest.mark.parametrize('n_axes', [None, 2])
def test_kr_gm_to_gaussian_matches_jax(axis_aligned, n_axes):
    """Closed form up to the eigenvectors: atol 1e-4 where the output's
    |cdf| < 0.999 (|z| < 3.29), first n_axes rotated channels."""
    gm = make_gm(30, c=3, logstd=-0.4)
    x = np.random.default_rng(31).standard_normal((2, 4, 3, 3, 3)).astype(
        np.float32)
    ev = _j_eigvecs(gm, axis_aligned)
    want = np.asarray(j_gm.gm_samples_to_gaussian_samples(
        jx(gm), jnp.asarray(x), n_axes=n_axes, rng=jax.random.PRNGKey(0),
        axis_aligned=axis_aligned))
    a = 3 if n_axes is None else n_axes
    got = t_gm._kr_to_gaussian(th(gm), torch.from_numpy(x), ev, a, 1e-6,
                               torch.Generator().manual_seed(0),
                               axis_aligned).numpy()
    if not axis_aligned:
        evn = np.broadcast_to(ev.numpy()[:, None], (2, 1) + ev.shape[1:])
        want = np.einsum('bnhwc,bnhwcd->bnhwd', want, evn)
        got = np.einsum('bnhwc,bnhwcd->bnhwd', got, evn)
    want, got = want[..., :a], got[..., :a]
    ok = np.abs(want) < 3.29
    assert ok.mean() > 0.9
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-4)


def test_kr_round_trip():
    """z -> GM samples -> z with the port's own eigenvectors, atol 5e-3, as
    tests/test_gm_ops.py:152-159 holds the JAX functions."""
    gm = make_gm(32, b=1, k=3, h=2, w=2, c=3, logstd=-0.2)
    z = torch.from_numpy(np.random.default_rng(33).standard_normal(
        (1, 8, 2, 2, 3)).astype(np.float32))
    x = t_gm.gaussian_samples_to_gm_samples(th(gm), z, n_steps=24)
    z_rec = t_gm.gm_samples_to_gaussian_samples(th(gm), x)
    np.testing.assert_allclose(z_rec.numpy(), z.numpy(), atol=5e-3)


def test_kr_backward_steps_give_gradients():
    """With backward_steps > 0 the transport is differentiable in the
    means (the last steps are plain PyTorch), and stays near the no-grad
    result."""
    gm = th(make_gm(34, b=1, k=3, h=2, w=2, c=2))
    gm['means'].requires_grad_()
    z = torch.from_numpy(np.random.default_rng(35).standard_normal(
        (1, 4, 2, 2, 2)).astype(np.float32))
    x = t_gm.gaussian_samples_to_gm_samples(gm, z, n_steps=12,
                                            backward_steps=2)
    x.sum().backward()
    assert torch.isfinite(gm['means'].grad).all() and gm['means'].grad.any()
    x0 = t_gm.gaussian_samples_to_gm_samples(gm, z, n_steps=12)
    np.testing.assert_allclose(x.detach().numpy(), x0.detach().numpy(),
                               atol=1e-3)


# ---- random draws, by moments ------------------------------------------------------

def test_gm_to_sample_moments():
    """20000 draws: the empirical mean within 0.05 of gm_to_mean and the
    channel-averaged variance within 8% of gm_to_iso_gaussian's, as
    tests/test_gm_ops.py holds the JAX sampler."""
    gm = th(make_gm(36))
    g = torch.Generator().manual_seed(0)
    s = t_gm.gm_to_sample(g, gm, n_samples=20000)
    assert s.shape == (2, 20000, 3, 3, 2)
    iso = t_gm.gm_to_iso_gaussian(gm)[0]
    np.testing.assert_allclose(s.mean(1).numpy(), t_gm.gm_to_mean(gm).numpy(),
                               atol=0.05)
    np.testing.assert_allclose(s.var(1).mean(-1, keepdim=True).numpy(),
                               iso['var'].numpy(), rtol=0.08)
    # power 2 with cov_sharpen: the draws follow the sharpened mixture mean
    s2 = t_gm.gm_to_sample(g, gm, gm_power=2.0, n_samples=20000,
                           cov_sharpen=True)
    np.testing.assert_allclose(s2.mean(1).numpy(),
                               t_gm.gm_to_mean(gm, 2.0).numpy(), atol=0.05)


def test_kl_and_entropy_match_jax_estimates():
    """KL(p || p) is 0 exactly; KL(p || q) and the entropy from 4096 draws
    each side agree with JAX's estimates within 10% (their Monte Carlo
    errors are a few percent at this count)."""
    p, q = make_gm(37), make_gm(38)
    g = torch.Generator().manual_seed(1)
    assert float(t_gm.gm_kl_div(g, th(p), th(p)).abs().max()) == 0.0
    kl_t = float(t_gm.gm_kl_div(g, th(p), th(q), n_samples=4096).mean())
    kl_j = float(j_gm.gm_kl_div(jax.random.PRNGKey(2), jx(p), jx(q),
                                n_samples=4096).mean())
    np.testing.assert_allclose(kl_t, kl_j, rtol=0.1)
    ent_t = t_gm.gm_entropy(g, th(p), n_samples=4096)
    ent_j = j_gm.gm_entropy(jax.random.PRNGKey(3), jx(p), n_samples=4096)
    assert ent_t.shape == ent_j.shape == (2, 1, 3, 3)
    np.testing.assert_allclose(float(ent_t.mean()), float(ent_j.mean()),
                               rtol=0.1)
