"""Port parity: timestep warping, ArcFlowPolicy and the closed-form
momentum integrator (arcflow_tpu_torch.diffusion) against the JAX package.

Inputs come from numpy and go through both; everything is fp32 on the CPU.
Tolerance rtol=2e-5 / atol=2e-6 unless stated: both sides evaluate the
same elementwise fp32 formulas, so they differ only by the last-bit
rounding of exp/expm1/softmax between XLA and PyTorch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.diffusion import ArcFlowPolicy as JPolicy
from arcflow_tpu.diffusion import ContinuousTimeStepSampler as JSampler
from arcflow_tpu.diffusion import momentum_integration as j_integrate
from arcflow_tpu.diffusion.integrator import _safe_expm1_over_x as j_expm1
from arcflow_tpu_torch.diffusion import ArcFlowPolicy as TPolicy
from arcflow_tpu_torch.diffusion import ContinuousTimeStepSampler as TSampler
from arcflow_tpu_torch.diffusion import momentum_integration as t_integrate
from arcflow_tpu_torch.diffusion.integrator import \
    _safe_expm1_over_x as t_expm1

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-6)


def _mixture(seed, b=2, k=4, shape=(6, 6, 3), sigma_src=0.9):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        means=rng.standard_normal((b, k) + shape).astype(f),
        logweights=(0.5 * rng.standard_normal(
            (b, k) + (1,) * len(shape))).astype(f),
        # rates in roughly [log 0.2, log 4], like the head init
        loggammas=rng.uniform(-1.6, 1.4, (b, k - 1) + (1,) * len(shape)
                              ).astype(f),
        x=rng.standard_normal((b,) + shape).astype(f),
        sigma=np.full((b,), sigma_src, f))


def _policies(m, eps=1e-4):
    out = dict(means=m['means'], logweights=m['logweights'],
               loggammas=m['loggammas'])
    jp = JPolicy.create({k: jnp.asarray(v) for k, v in out.items()},
                        jnp.asarray(m['x']), jnp.asarray(m['sigma']), eps=eps)
    tp = TPolicy.create({k: torch.from_numpy(v) for k, v in out.items()},
                        torch.from_numpy(m['x']), torch.from_numpy(m['sigma']),
                        eps=eps)
    return jp, tp


@pytest.mark.parametrize('dynamic,seq_len', [(False, None), (True, 4096),
                                             (True, 1024)])
def test_warp_t_matches_jax(dynamic, seq_len):
    t = np.linspace(0.0, 1.0, 17, dtype=np.float32)
    js = JSampler(shift=3.2, use_dynamic_shifting=dynamic)
    ts = TSampler(shift=3.2, use_dynamic_shifting=dynamic)
    assert ts.get_shift(seq_len) == pytest.approx(js.get_shift(seq_len),
                                                  rel=1e-12)
    np.testing.assert_allclose(
        ts.warp_t(torch.from_numpy(t), seq_len=seq_len).numpy(),
        np.asarray(js.warp_t(jnp.asarray(t), seq_len=seq_len)), **TOL)


def test_policy_weights_decay_velocity_match_jax():
    jp, tp = _policies(_mixture(0))
    np.testing.assert_allclose(tp.weights().numpy(),
                               np.asarray(jp.weights()), **TOL)
    dt = np.array([0.3, 0.05], np.float32)
    np.testing.assert_allclose(tp.decay(torch.from_numpy(dt)).numpy(),
                               np.asarray(jp.decay(jnp.asarray(dt))), **TOL)
    sig = np.array([0.6, 0.85], np.float32)
    np.testing.assert_allclose(tp.velocity(torch.from_numpy(sig)).numpy(),
                               np.asarray(jp.velocity(jnp.asarray(sig))),
                               **TOL)


@pytest.mark.parametrize('temp', [0.5, 1.0, 2.5])
def test_policy_temperature_matches_jax(temp):
    jp, tp = _policies(_mixture(1))
    np.testing.assert_allclose(tp.temperature(temp).weights().numpy(),
                               np.asarray(jp.temperature(temp).weights()),
                               **TOL)


@pytest.mark.parametrize('case', ['from_source', 'mid_rollout', 'zero_span',
                                  'return_mid'])
def test_momentum_integration_matches_jax(case):
    m = _mixture(2)
    jp, tp = _policies(m)
    b = m['x'].shape[0]
    x, s0, s1 = m['x'], np.full((b,), 0.9, np.float32), \
        np.full((b,), 0.4, np.float32)
    if case == 'mid_rollout':       # x != x_src and sigma_start != sigma_src
        x, s0, s1 = x + 0.3, np.full((b,), 0.6, np.float32), \
            np.full((b,), 0.2, np.float32)
    if case == 'zero_span':         # tests/test_integrator.py:73
        s0 = s1 = np.full((b,), 0.7, np.float32)
    kw = dict(return_mid=case == 'return_mid')
    j_out = j_integrate(jp, jnp.asarray(x), jnp.asarray(s0), jnp.asarray(s1),
                        **kw)
    t_out = t_integrate(tp, torch.from_numpy(x), torch.from_numpy(s0),
                        torch.from_numpy(s1), **kw)
    j_out = j_out if isinstance(j_out, tuple) else (j_out,)
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    for a, r in zip(t_out, j_out):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
    if case == 'zero_span':
        np.testing.assert_allclose(t_out[0].numpy(), x, rtol=0, atol=1e-6)


@pytest.mark.parametrize('sign', [1.0, -1.0])
def test_safe_expm1_over_x_clamp_matches_jax(sign):
    """|x| under eps takes the sign-safe clamp (integrator.py:28-36): the
    values straddle eps on both sides of zero, and 0 itself counts as
    positive."""
    eps = 1e-4
    x = sign * np.array([0.0, 1e-8, 3e-5, 9.99e-5, 1e-4, 2e-4, 0.5, 3.0],
                        np.float32)
    t = t_expm1(torch.from_numpy(x), eps).numpy()
    np.testing.assert_allclose(t, np.asarray(j_expm1(jnp.asarray(x), eps)),
                               **TOL)
    assert np.all(np.isfinite(t))


def test_momentum_integration_small_rates_take_the_clamp():
    """Rates so small that |rate * dt| < eps: the factor clamps to
    expm1(+-eps)/(+-eps) on both signs, identically in both packages."""
    m = _mixture(3)
    m['loggammas'] = np.where(np.arange(3)[None, :, None, None, None] % 2,
                              -1e-6, 1e-6).astype(np.float32) \
        * np.ones_like(m['loggammas'])
    jp, tp = _policies(m)
    s0 = np.full((2,), 0.9, np.float32)
    s1 = np.full((2,), 0.5, np.float32)
    np.testing.assert_allclose(
        t_integrate(tp, torch.from_numpy(m['x']), torch.from_numpy(s0),
                    torch.from_numpy(s1)).numpy(),
        np.asarray(j_integrate(jp, jnp.asarray(m['x']), jnp.asarray(s0),
                               jnp.asarray(s1))), **TOL)


def test_create_rejects_k_gamma_mismatch():
    m = _mixture(4)
    bad = dict(means=torch.from_numpy(m['means']),
               logweights=torch.from_numpy(m['logweights']),
               loggammas=torch.from_numpy(m['means'][:, :, :1, :1, :1]))
    with pytest.raises(ValueError, match='K-1=3'):
        TPolicy.create(bad, torch.from_numpy(m['x']),
                       torch.from_numpy(m['sigma']))


def test_integration_ignores_autocast():
    """Autocast to bf16 must not reach the integrator's fp32 math."""
    m = _mixture(5)
    _, tp = _policies(m)
    x = torch.from_numpy(m['x'])
    s0, s1 = torch.full((2,), 0.9), torch.full((2,), 0.3)
    ref = t_integrate(tp, x, s0, s1)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        out = t_integrate(tp, x, s0, s1)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
