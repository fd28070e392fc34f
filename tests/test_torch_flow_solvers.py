"""Port parity: the high-order flow solvers
(``diffusion/schedulers/flow_dpmsolver.py``) and ``GaussianFlow``'s
stateful sampling loop against the JAX package.

Both samplers run the analytic denoiser of
``tests/test_class_image_and_solvers.py`` (the exact u, or x0, for x0 ~
N(MU, 0.25^2)) from the same noise (a numpy seed). Tolerance: max abs 1e-5
on the samples of every deterministic solver, fp32.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.diffusion import GaussianFlow as JGaussianFlow
from arcflow_tpu_torch import SCHEDULERS
from arcflow_tpu_torch.diffusion import GaussianFlow
from arcflow_tpu_torch.diffusion.schedulers import (
    FlowDEISScheduler, FlowDPMSolverScheduler, FlowEulerODEScheduler,
    FlowSASolverScheduler, FlowSDEScheduler, FlowUniPCScheduler)

ATOL = 1e-5
MU, S2, T = np.array([0.8, -0.3], np.float32), 0.25 ** 2, 1000
SOLVERS = ('FlowDPMSolver', 'FlowUniPC', 'FlowDEIS', 'FlowSASolver')


def analytic(x_t, t, x0_out, xp):
    """u (or x0) of the exact posterior for x0 ~ N(MU, S2) in the array
    module ``xp`` (jnp or torch)."""
    sigma = (t / T).reshape(-1, 1, 1, 1)
    alpha = 1 - sigma
    var = alpha ** 2 * S2 + sigma ** 2
    mu = xp.asarray(MU).reshape(1, 1, 1, 2)
    x0_hat = mu + alpha * S2 / var * (x_t - alpha * mu)
    eps_hat = sigma * (x_t - alpha * mu) / var
    return x0_hat if x0_out else eps_hat - x0_hat


class JAnalytic:
    def __init__(self, x0_out=False):
        self.x0_out = x0_out

    def apply(self, variables, x_t, t, **kw):
        return analytic(x_t, t, self.x0_out, jnp)


class TAnalytic(torch.nn.Module):
    def __init__(self, x0_out=False):
        super().__init__()
        self.x0_out = x0_out

    def forward(self, x_t, t, **kw):
        return analytic(x_t, t, self.x0_out, torch)


def noise(n=256, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 1, 1, 2)).astype(np.float32)


def sample_both(sampler, steps=8, prediction_type='u', **sampler_kwargs):
    cfg = dict(sampler=sampler, num_timesteps=steps,
               prediction_type=prediction_type, sampler_kwargs=sampler_kwargs)
    x0_out = prediction_type == 'x0'
    jf = JGaussianFlow(denoising=JAnalytic(x0_out), num_timesteps=T,
                       test_cfg=cfg)
    tf = GaussianFlow(denoising=TAnalytic(x0_out), num_timesteps=T,
                      test_cfg=cfg)
    z = noise()
    want = np.asarray(jf.forward_test({}, jax.random.PRNGKey(1),
                                      jnp.asarray(z)))
    got = tf.forward_test(torch.from_numpy(z),
                          torch.Generator().manual_seed(1)).numpy()
    return got, want


@pytest.mark.parametrize('prediction_type', ['u', 'x0'])
@pytest.mark.parametrize('sampler', SOLVERS)
def test_solver_samples_match_jax(sampler, prediction_type):
    kw = dict(tau=0.0) if sampler == 'FlowSASolver' else {}
    got, want = sample_both(sampler, prediction_type=prediction_type, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and they land on the target, as JAX's contract test asks
    x = got.reshape(-1, 2)
    np.testing.assert_allclose(x.mean(0), MU, atol=0.06)
    np.testing.assert_allclose(x.std(0), 0.25, atol=0.06)


@pytest.mark.parametrize('sampler,kwargs', [
    ('FlowDPMSolver', dict(solver_order=1)),
    ('FlowDEIS', dict(solver_order=1, shift=3.0)),
    ('FlowAdapter', dict(base_scheduler='DEISMultistep')),
    ('FlowAdapter', dict(base_scheduler='UniPCMultistep', shift=2.0)),
    ('FlowAdapter', dict(base_scheduler='EulerDiscrete')),
])
def test_solver_options_match_jax(sampler, kwargs):
    got, want = sample_both(sampler, steps=6, **kwargs)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_sasolver_tau_zero_equals_dpmsolver():
    """tau = 0 is DPM-Solver++(2M) exactly; tau > 0 draws from the
    generator (and needs one), stays on the distribution and differs."""
    def run(sampler, generator=None, **kw):
        flow = GaussianFlow(denoising=TAnalytic(), num_timesteps=T,
                            test_cfg=dict(sampler=sampler, num_timesteps=6,
                                          sampler_kwargs=kw))
        return flow.forward_test(torch.from_numpy(noise(512, 5)), generator)
    ref = run('FlowDPMSolver')
    torch.testing.assert_close(run('FlowSASolver', tau=0.0), ref, rtol=0,
                               atol=1e-6)
    x = run('FlowSASolver', torch.Generator().manual_seed(6), tau=1.0)
    assert (x - ref).abs().max() > 1e-3
    assert (x.reshape(-1, 2).mean(0) - torch.from_numpy(MU)).abs().max() \
        < 0.15
    with pytest.raises(ValueError, match='needs a generator'):
        run('FlowSASolver', tau=1.0)


def test_sasolver_churn_matches_jax_with_replayed_draws():
    """SA-Solver at tau = 1 (a noise draw per step): JAX's draws, recorded
    with its scan run as a Python loop, replayed into the port's
    ``torch.randn``."""
    cfg = dict(sampler='FlowSASolver', num_timesteps=6,
               sampler_kwargs=dict(tau=1.0))
    jf = JGaussianFlow(denoising=JAnalytic(), num_timesteps=T, test_cfg=cfg)
    tf = GaussianFlow(denoising=TAnalytic(), num_timesteps=T, test_cfg=cfg)
    z = noise(64, 7)
    draws, real = [], jax.random.normal

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        draws.append(np.asarray(out))
        return out
    with jax.disable_jit(), mock.patch.object(jax.random, 'normal',
                                              recording):
        want = np.asarray(jf.forward_test({}, jax.random.PRNGKey(8),
                                          jnp.asarray(z)))
    assert len(draws) == 6
    it = iter(draws)

    def replay(*size, generator=None, device=None, dtype=None):
        x = next(it)
        assert tuple(size[0]) == x.shape and generator is not None
        return torch.from_numpy(np.array(x, np.float32))
    with mock.patch.object(torch, 'randn', replay):
        got = tf.forward_test(torch.from_numpy(z), torch.Generator())
    assert next(it, None) is None
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_stateful_steps_match_jax_step_by_step():
    """step_with_state's (x, state) against JAX's on one pair of steps,
    the state dict's keys and values included."""
    from arcflow_tpu.diffusion.schedulers import (
        FlowDEISScheduler as JDEIS)
    rng = np.random.default_rng(3)
    x, u1, u2 = (rng.standard_normal((2, 4, 4, 2)).astype(np.float32)
                 for _ in range(3))
    js, ts = JDEIS(), FlowDEISScheduler()
    jx, jst = js.step_with_state(jnp.asarray(u1), jnp.asarray(x), 0.9, 0.6,
                                 js.init_state(jnp.asarray(x)))
    tx, tst = ts.step_with_state(torch.from_numpy(u1), torch.from_numpy(x),
                                 np.float32(0.9), np.float32(0.6),
                                 ts.init_state(torch.from_numpy(x)))
    assert set(tst) == set(jst)
    jx, jst = js.step_with_state(jnp.asarray(u2), jx, 0.6, 0.0, jst)
    tx, tst = ts.step_with_state(torch.from_numpy(u2), tx, np.float32(0.6),
                                 np.float32(0.0), tst)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)
    for k in jst:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=ATOL, rtol=1e-6)


def test_registry_and_dispatcher():
    """SCHEDULERS holds every JAX name; the dispatcher maps the reference's
    diffusers names (UniPC by default), filters kwargs to the solver's
    fields and refuses other names with AttributeError."""
    from arcflow_tpu.registry import SCHEDULERS as J_SCHEDULERS
    assert set(J_SCHEDULERS.keys()) <= set(SCHEDULERS.keys())
    build = SCHEDULERS.get('FlowAdapterScheduler')
    assert type(build()) is FlowUniPCScheduler
    for name, cls in (('DPMSolverMultistep', FlowDPMSolverScheduler),
                      ('DPMSolverSinglestep', FlowDPMSolverScheduler),
                      ('DEISMultistep', FlowDEISScheduler),
                      ('SASolver', FlowSASolverScheduler),
                      ('EulerDiscrete', FlowEulerODEScheduler),
                      ('EulerAncestralDiscrete', FlowSDEScheduler)):
        assert type(build(base_scheduler=name)) is cls, name
    deis = build(base_scheduler='DEISMultistep', shift=3.2,
                 prediction_type='flow_prediction', use_flow_sigmas=True)
    assert deis.shift == 3.2
    sa = build(base_scheduler='SASolver', tau=0.5)
    assert sa.tau == 0.5 and sa.stateful
    with pytest.raises(AttributeError, match='Unsupported base_scheduler'):
        build(base_scheduler='Nope')
