"""Port parity: the GMFlow family (arcflow_tpu_torch.diffusion.gmflow, its
schedulers, timestep sampler, loss, toy denoisers and Diffusion2D) against
the JAX package.

The flax denoiser's parameters, jittered so the zero-initialised heads are
live, are carried over with ``jax_params_to_torch`` and ``strict=True``;
everything runs in fp32. Random draws differ between jax.random and
torch.Generator, so the JAX draws of a training step are recorded and
replayed in place of ``torch.rand``/``torch.randn``, as
tests/test_torch_train.py does, and the sampler's 'sample' mode is compared
by moments. Tolerances: the denoiser's outputs atol 1e-5; closed-form
mixture math rtol 1e-5, atol 1e-6; the training loss rel 1e-5 and each
gradient rel L2 1e-4 (fp32 sums in another order through a 3-layer MLP);
sampling trajectories atol 1e-4 after 8-16 steps; anything through eigh
(the spectral loss) atol 1e-4.
"""

from typing import Any
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from arcflow_tpu.data import CheckerboardData as JCheckerboard
from arcflow_tpu.diffusion import GMFlow as JGMFlow
from arcflow_tpu.diffusion import gmflow as j_gmflow
from arcflow_tpu.diffusion.sampler import ContinuousTimeStepSampler as JSampler
from arcflow_tpu.diffusion.schedulers import (FlowEulerODEScheduler as JODE,
                                              FlowSDEScheduler as JSDE)
from arcflow_tpu.models import SpectrumMLP as JSpectrum
from arcflow_tpu.models import ToyGMFlowDenoiser as JDenoiser
from arcflow_tpu.models.base import Diffusion2D as JDiffusion2D
from arcflow_tpu_torch.data import CheckerboardData
from arcflow_tpu_torch.diffusion import GMFlow, GMFlowNLLLoss
from arcflow_tpu_torch.diffusion import gmflow as t_gmflow
from arcflow_tpu_torch.diffusion.sampler import ContinuousTimeStepSampler
from arcflow_tpu_torch.diffusion.schedulers import (FlowEulerODEScheduler,
                                                    FlowSDEScheduler)
from arcflow_tpu_torch.models import (Diffusion2D, SpectrumMLP,
                                      ToyGMFlowDenoiser)
from arcflow_tpu_torch.pipelines import jax_params_to_torch
from arcflow_tpu_torch.runner import (EmaConfig, TrainState, build_optimizers,
                                      build_train_step)

torch.set_num_threads(1)

CLOSED = dict(rtol=1e-5, atol=1e-6)
K, HIDDEN, HW = 4, (32, 32), (2, 3)
LOSS_INFO = dict(pred_means='means', target='x_t_low', pred_logstds='logstds',
                 pred_logweights='logweights')
# configs/gmflow/checkerboard_gmflow.py:6-36 (model, train_cfg, test_cfg,
# optimizer, data) and :41-44 (the EMA hook)
CKB_MODEL = dict(
    data_shape=(1, 1, 2), diffusion_use_ema=True,
    diffusion=dict(type='GMFlow',
                   denoising=dict(type='ToyGMFlowDenoiser', out_channels=2,
                                  num_gaussians=8, hidden=(256, 256, 256),
                                  num_timesteps=1000),
                   flow_loss=dict(type='GMFlowNLLLoss', data_info=LOSS_INFO),
                   num_timesteps=1000,
                   timestep_sampler=dict(type='ContinuousTimeStepSampler',
                                         shift=1.0)))
CKB_TRAIN_CFG = dict(trans_ratio=1.0, diffusion_grad_clip=10.0)
CKB_TEST_CFG = dict(sampler='FlowEulerODE', num_timesteps=16,
                    output_mode='mean', order=2, num_substeps=2)
CKB_OPT = dict(diffusion=dict(type='AdamW', lr=1e-3, weight_decay=0.0))
CKB_EMA = dict(type='ExponentialMovingAverageHookMod',
               module_keys=('diffusion_ema',), interp_mode='lerp',
               interval=1, start_iter=100, momentum_policy='karras',
               momentum_cfg=dict(gamma=7.0))


class JCond(fnn.Module):
    """The flax toy denoiser plus a conditioning offset on its means, so
    that CFG's two halves differ."""
    inner: Any

    @fnn.compact
    def __call__(self, x_t, t, cond=None, **kwargs):
        out = self.inner(x_t, t)
        if cond is not None:
            out = dict(out, means=out['means']
                       + 0.5 * cond[:, None, None, None, None])
        return out


class TCond(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x_t, t, cond=None, **kwargs):
        out = self.inner(x_t, t)
        if cond is not None:
            out = dict(out, means=out['means']
                       + 0.5 * cond[:, None, None, None, None])
        return out


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _jitter(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return _map(lambda x: np.asarray(x) + scale * rng.standard_normal(
        np.shape(x)).astype(np.float32), jax.device_get(tree))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def j_denoiser(hw=HW, k=K, hidden=HIDDEN):
    return JDenoiser(out_channels=2, num_gaussians=k, hidden=hidden)


def t_denoiser(hw=HW, k=K, hidden=HIDDEN):
    return ToyGMFlowDenoiser(out_channels=2, num_gaussians=k, hidden=hidden,
                             hw=hw, device='cpu')


def flax_params(module, hw=HW, seed=0, **kwargs):
    params = jax.jit(module.init)(jax.random.PRNGKey(seed),
                                  jnp.zeros((2, *hw, 2)), jnp.zeros((2,)),
                                  **kwargs)['params']
    return _jitter(params, seed + 100)


def load(module, params):
    module.load_state_dict(jax_params_to_torch(params), strict=True)
    return module


def gmflows(cond=False, spectrum=False, trans_ratio=1.0, test_cfg=None):
    """(JAX GMFlow, its params, port GMFlow) with the same weights."""
    test_cfg = test_cfg or dict(sampler='FlowEulerODE', num_timesteps=8,
                                output_mode='mean')
    train_cfg = dict(trans_ratio=trans_ratio)
    j_den, t_den = j_denoiser(), t_denoiser()
    if cond:
        j_den, t_den = JCond(j_den), TCond(t_den)
    params = flax_params(j_den, cond=jnp.zeros((2,))) if cond \
        else flax_params(j_den)
    j_spec = t_spec = None
    if spectrum:
        # a wide mixture (std e^0.3), so the residuals of training stay off
        # the KR whitening's saturated tails
        params['logstd'] = np.full((1,), 0.3, np.float32)
        j_spec = JSpectrum(height=HW[0], width=HW[1], hidden=16)
        s_params = _jitter(jax.jit(j_spec.init)(
            jax.random.PRNGKey(5), jnp.zeros((2, *HW, 2)),
            jnp.zeros((2, *HW, 1)))['params'], 6)
        t_spec = load(SpectrumMLP(height=HW[0], width=HW[1], hidden=16,
                                  channels=2, device='cpu'), s_params)
    load(t_den, params)
    if spectrum:
        params = {'denoising': params, 'spectrum_net': s_params}
    jf = JGMFlow(denoising=j_den, spectrum_net=j_spec,
                 flow_loss=dict(type='GMFlowNLLLoss', data_info=LOSS_INFO),
                 num_timesteps=1000, train_cfg=train_cfg, test_cfg=test_cfg)
    tf = GMFlow(denoising=t_den, spectrum_net=t_spec,
                flow_loss=GMFlowNLLLoss(data_info=LOSS_INFO),
                num_timesteps=1000, train_cfg=train_cfg, test_cfg=test_cfg)
    return jf, params, tf


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def gm_u(seed, b=3, k=K, hw=HW):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, k, *hw, 1)).astype(np.float32)
    return dict(means=rng.standard_normal((b, k, *hw, 2)).astype(np.float32),
                logstds=np.full((b, 1, 1, 1, 1), -0.7, np.float32),
                logweights=(logits - np.log(np.exp(logits).sum(
                    1, keepdims=True))).astype(np.float32))


def jx(tree):
    return _map(jnp.asarray, tree)


def th(tree):
    return _map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def close(got, want, tol=CLOSED):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---- the denoisers ------------------------------------------------------------

def test_denoiser_carried_over_from_flax():
    """Outputs within atol 1e-5; names and shapes match ``strict=True``."""
    j_den = j_denoiser()
    params = flax_params(j_den)
    t_den = load(t_denoiser(), params)
    x, t = rand(1, 3, *HW, 2), np.array([0.0, 370.5, 1000.0], np.float32)
    want = j_den.apply({'params': params}, jnp.asarray(x), jnp.asarray(t))
    got = t_den(torch.from_numpy(x), torch.from_numpy(t))
    assert got['logstds'].shape == (3, 1, 1, 1, 1)
    close(got, want, dict(rtol=0, atol=1e-5))


def test_fresh_denoiser_follows_the_flax_init():
    """Zero log-weight head (uniform weights), logstd -1, zero biases."""
    out = t_denoiser()(torch.zeros(2, *HW, 2), torch.zeros(2))
    np.testing.assert_allclose(out['logweights'].detach().numpy(),
                               np.log(1 / K), rtol=1e-6)
    assert float(out['logstds'][0].detach()) == -1.0


def test_spectrum_mlp_carried_over_from_flax():
    j_spec = JSpectrum(height=HW[0], width=HW[1], hidden=16)
    p = _jitter(j_spec.init(jax.random.PRNGKey(0), jnp.zeros((2, *HW, 2)),
                            jnp.zeros((2, *HW, 1)))['params'], 1)
    t_spec = load(SpectrumMLP(height=HW[0], width=HW[1], hidden=16,
                              channels=2, device='cpu'), p)
    mean, var = rand(2, 2, *HW, 2), np.abs(rand(3, 2, *HW, 1))
    close(t_spec(torch.from_numpy(mean), torch.from_numpy(var)),
          j_spec.apply({'params': p}, jnp.asarray(mean), jnp.asarray(var)),
          dict(rtol=0, atol=1e-5))


# ---- GM-space math ------------------------------------------------------------

def test_u_to_x_0_all_forms():
    jf, _, tf = gmflows()
    x_t, t = rand(4, 3, *HW, 2), np.array([400.0, 50.0, 990.0], np.float32)
    gm = gm_u(5)
    close(tf.u_to_x_0(th(gm), torch.from_numpy(x_t), torch.from_numpy(t)),
          jf.u_to_x_0(jx(gm), jnp.asarray(x_t), jnp.asarray(t)))
    g = dict(mean=rand(6, 3, *HW, 2), var=np.abs(rand(7, 3, *HW, 1)))
    close(tf.u_to_x_0(th(g), torch.from_numpy(x_t), torch.from_numpy(t)),
          jf.u_to_x_0(jx(g), jnp.asarray(x_t), jnp.asarray(t)))
    u = rand(8, 3, *HW, 2)
    sig = t / 1000
    close(tf.u_to_x_0(torch.from_numpy(u), torch.from_numpy(x_t),
                      sigma=torch.from_numpy(sig)),
          jf.u_to_x_0(jnp.asarray(u), jnp.asarray(x_t),
                      sigma=jnp.asarray(sig)))


@pytest.mark.parametrize('prediction_type', ['u', 'x0'])
def test_reverse_transition_gm(prediction_type):
    jf, _, tf = gmflows()
    x, gm = rand(9, 3, *HW, 2), gm_u(10)
    lo, hi = np.array([0.0, 0.3, 0.5], np.float32), \
        np.array([0.2, 0.7, 0.9], np.float32)
    close(tf.reverse_transition(th(gm), torch.from_numpy(x),
                                torch.from_numpy(lo), torch.from_numpy(hi),
                                prediction_type=prediction_type),
          jf.reverse_transition(jx(gm), jnp.asarray(x), jnp.asarray(lo),
                                jnp.asarray(hi),
                                prediction_type=prediction_type))


def test_reverse_transition_sample_mode_with_replayed_noise():
    jf, _, tf = gmflows()
    x, u = rand(11, 3, *HW, 2), rand(12, 3, *HW, 2)
    lo, hi = np.array([0.0, 0.3, 0.5], np.float32), \
        np.array([0.2, 0.7, 0.9], np.float32)
    key = jax.random.PRNGKey(3)
    want = jf.reverse_transition(jnp.asarray(u), jnp.asarray(x),
                                 jnp.asarray(lo), jnp.asarray(hi), rng=key)
    noise = np.array(jax.random.normal(key, x.shape))
    with mock.patch.object(torch, 'randn',
                           lambda *a, **k: torch.from_numpy(noise)):
        got = tf.reverse_transition(torch.from_numpy(u), torch.from_numpy(x),
                                    torch.from_numpy(lo),
                                    torch.from_numpy(hi),
                                    generator=torch.Generator())
    close(got, want)


def test_posterior_mean_and_probabilistic_guidance():
    gm = gm_u(13)
    x_t, x_src = rand(14, 3, *HW, 2), rand(15, 3, *HW, 2)
    s_t = np.array([0.2, 0.4, 0.1], np.float32)
    s_src = np.array([0.6, 0.9, 0.5], np.float32)
    close(t_gmflow.gmflow_posterior_mean(th(gm), *th(dict(
        a=x_t, b=x_src, c=s_t, d=s_src)).values()),
        j_gmflow.gmflow_posterior_mean(jx(gm), *jx(dict(
            a=x_t, b=x_src, c=s_t, d=s_src)).values()))
    cond, uncond = rand(16, 3, *HW, 2), rand(17, 3, *HW, 2)
    var = np.abs(rand(18, 3, 1, 1, 1)) + 0.1
    for orthogonal in (0.0, 1.0):
        got = t_gmflow.probabilistic_guidance(
            *th(dict(a=cond, b=var, c=uncond)).values(), 0.3,
            orthogonal=orthogonal)
        want = j_gmflow.probabilistic_guidance(
            *jx(dict(a=cond, b=var, c=uncond)).values(), 0.3,
            orthogonal=orthogonal)
        for x, y in zip(got, want):
            close(x, y)


def test_apply_probabilistic_cfg():
    jf, _, tf = gmflows()
    gm = gm_u(19, b=4)
    gm['means'][2:] += 0.4                         # cond differs from uncond
    got = tf._apply_probabilistic_cfg(th(gm), 2, 0.3, 1.0)
    want = jf._apply_probabilistic_cfg(jx(gm), 2, 0.3, 1.0)
    for x, y in zip(got, want):
        close(x, y)


# ---- the timestep sampler, forward process and schedulers -------------------------

@pytest.mark.parametrize('kw,sampler_kw', [
    (dict(), dict(shift=3.0)),
    (dict(raw_t_range=(0.9, 0.2)), dict()),
    (dict(seq_len=1024), dict(use_dynamic_shifting=True)),
    (dict(), dict(logit_normal_enable=True, logit_normal_mean=0.3,
                  logit_normal_std=1.2))])
def test_timestep_sampler_draws_with_replayed_numbers(kw, sampler_kw):
    key = jax.random.PRNGKey(4)
    want = JSampler(num_timesteps=1000, **sampler_kw)(key, 6, **kw)
    draw = (jax.random.normal if sampler_kw.get('logit_normal_enable')
            else jax.random.uniform)(key, (6,))
    replay = lambda *a, **k: torch.from_numpy(np.array(draw))  # noqa: E731
    name = 'randn' if sampler_kw.get('logit_normal_enable') else 'rand'
    with mock.patch.object(torch, name, replay):
        got = ContinuousTimeStepSampler(num_timesteps=1000, **sampler_kw)(
            torch.Generator(), 6, **kw)
    close(got, want)


def test_forward_process():
    jf, _, tf = gmflows()
    x0, noise = rand(20, 3, *HW, 2), rand(21, 3, *HW, 2)
    t = np.array([10.0, 500.0, 999.0], np.float32)
    for x, y in zip(tf.sample_forward_diffusion(*th(dict(
            a=x0, b=t, c=noise)).values()),
            jf.sample_forward_diffusion(*jx(dict(a=x0, b=t,
                                                 c=noise)).values())):
        close(x, y)
    lo, hi = np.array([0.0, 0.3, 0.5], np.float32), \
        np.array([0.2, 0.7, 0.9], np.float32)
    got, scale = tf.forward_transition(*th(dict(a=x0, b=lo, c=hi)).values())
    want, j_scale = jf.forward_transition(*jx(dict(a=x0, b=lo,
                                                   c=hi)).values())
    close(got, want)
    close(scale, j_scale)


@pytest.mark.parametrize('kw,seq_len', [
    (dict(shift=3.2), None),
    (dict(use_dynamic_shifting=True), 4096),
    (dict(shift=2.0, terminal_sigma=0.02), None)])
def test_ode_scheduler_grid_and_step(kw, seq_len):
    j, t = JODE(**kw), FlowEulerODEScheduler(**kw)
    grid = t.set_timesteps(12, seq_len=seq_len)
    np.testing.assert_array_equal(grid, j.set_timesteps(12, seq_len=seq_len))
    np.testing.assert_array_equal(t.timesteps(12, seq_len),
                                  j.timesteps(12, seq_len))
    out, x = rand(22, 3, *HW, 2), rand(23, 3, *HW, 2)
    for pt in ('u', 'x0'):
        close(t.step(torch.from_numpy(out), torch.from_numpy(x), grid[3],
                     grid[4], prediction_type=pt),
              j.step(jnp.asarray(out), jnp.asarray(x), grid[3], grid[4],
                     prediction_type=pt))


@pytest.mark.parametrize('h', [0.0, 0.5, 1.0, 'inf'])
@pytest.mark.parametrize('pt', ['u', 'x0'])
def test_sde_scheduler_step_with_replayed_noise(h, pt):
    j, t = JSDE(h=h), FlowSDEScheduler(h=h)
    grid = t.set_timesteps(10)
    np.testing.assert_array_equal(grid, j.set_timesteps(10))
    out, x = rand(24, 3, *HW, 2), rand(25, 3, *HW, 2)
    key = jax.random.PRNGKey(7)
    want = j.step(jnp.asarray(out), jnp.asarray(x), grid[2], grid[3],
                  prediction_type=pt, rng=key)
    noise = np.array(jax.random.normal(key, x.shape))
    with mock.patch.object(torch, 'randn',
                           lambda *a, **k: torch.from_numpy(noise)):
        got = t.step(torch.from_numpy(out), torch.from_numpy(x), grid[2],
                     grid[3], prediction_type=pt,
                     generator=torch.Generator())
    close(got, want)


def test_build_test_scheduler_by_name():
    jf, _, tf = gmflows()
    for cfg in (dict(), dict(sampler='FlowSDE', sampler_kwargs=dict(h=0.5),
                             shift=2.0)):
        got, want = tf.build_test_scheduler(cfg), jf.build_test_scheduler(cfg)
        assert type(got).__name__ == type(want).__name__
        assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
            {f: getattr(want, f) for f in want.__dataclass_fields__}
    with pytest.raises(AttributeError, match='Cannot find sampler'):
        tf.build_test_scheduler(dict(sampler='FlowDPMSolver'))


# ---- training -------------------------------------------------------------------

def _jax_value_and_grads(jf, params, x0, key):
    draws = []
    real = dict(uniform=jax.random.uniform, normal=jax.random.normal)

    def recording(kind):
        def fn(*args, **kwargs):
            out = real[kind](*args, **kwargs)
            if not isinstance(out, jax.core.Tracer):
                draws.append((kind, np.asarray(out)))
            return out
        return fn

    with mock.patch.object(jax.random, 'uniform', recording('uniform')), \
            mock.patch.object(jax.random, 'normal', recording('normal')):
        (loss, logs), grads = jax.value_and_grad(
            lambda p: jf.forward_train(p, key, jnp.asarray(x0)),
            has_aux=True)(_map(jnp.asarray, params))
    return float(loss), logs, jax.device_get(grads), draws


def _replaying(draws):
    it = iter(draws)

    def make(kind):
        def fn(*size, generator=None, device=None, dtype=None, **kwargs):
            if len(size) == 1 and not isinstance(size[0], int):
                size = tuple(size[0])
            got, x = next(it)
            assert (got, x.shape) == (kind, tuple(size))
            return torch.from_numpy(np.array(x, np.float32)).to(device)
        return fn
    return make('uniform'), make('normal'), it


def _modules(tf):
    out = {'denoising': tf.denoising}
    if tf.spectrum_net is not None:
        out['spectrum_net'] = tf.spectrum_net
    return out


@pytest.mark.parametrize('trans_ratio,spectrum', [(1.0, False), (0.5, False),
                                                  (1.0, True)])
def test_forward_train_loss_and_grads_match_jax(trans_ratio, spectrum):
    """JAX's uniform and normal draws replayed in order: the timestep, the
    noise of x_t_low and the transition noise. Loss rel 1e-5, each gradient
    rel L2 1e-4. The spectral loss's KR whitening is detached on both sides
    and invariant to the eigenvectors' signs; its erfinv is steep near +-1,
    where a residual far out in the mixture's tails puts the cdf and the
    last-bit difference between XLA's erf and PyTorch's moves z, so that
    case runs a wide mixture (``gmflows``)."""
    jf, params, tf = gmflows(spectrum=spectrum, trans_ratio=trans_ratio)
    x0 = rand(26, 8, *HW, 2, scale=0.5)
    loss_j, logs_j, grads_j, draws = _jax_value_and_grads(
        jf, params, x0, jax.random.PRNGKey(8))
    assert [k for k, _ in draws] == ['uniform', 'normal', 'normal']
    rand_fn, randn_fn, rest = _replaying(draws)
    with mock.patch.object(torch, 'rand', rand_fn), \
            mock.patch.object(torch, 'randn', randn_fn):
        loss, logs = tf.forward_train(torch.Generator(), torch.from_numpy(x0))
    assert next(rest, None) is None
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for key in ('loss_transition', 'loss_diffusion') + (
            ('loss_spectral',) if spectrum else ()):
        np.testing.assert_allclose(float(logs[key]), float(logs_j[key]),
                                   rtol=1e-5)
    np.testing.assert_allclose(logs['per_sample_var'].numpy(),
                               np.asarray(logs_j['per_sample_var']),
                               rtol=1e-5)
    grads_j = grads_j if spectrum else {'denoising': grads_j}
    for prefix, module in _modules(tf).items():
        want = jax_params_to_torch(grads_j[prefix])
        got = dict(module.named_parameters())
        assert set(want) == set(got)
        for name, p in got.items():
            rel = _rel_l2(p.grad.numpy(), want[name].numpy())
            assert rel <= 1e-4, (prefix, name, rel)


def test_spectral_loss_matches_jax():
    """Residuals u = (x_t - x_0) / sigma drawn around the mixture's means,
    so the KR whitening stays off its saturated tails (see above): atol
    1e-4."""
    jf, params, tf = gmflows(spectrum=True)
    gm = gm_u(27)
    t = np.array([100.0, 500.0, 900.0], np.float32)
    x0 = rand(28, 3, *HW, 2)
    u = gm['means'][:, 0] + 0.5 * rand(29, 3, *HW, 2)
    x_t = (x0 + (t / 1000)[:, None, None, None] * u).astype(np.float32)
    want = jf.spectral_loss(jx(params['spectrum_net']), jx(gm),
                            jnp.asarray(x0), jnp.asarray(x_t), jnp.asarray(t))
    got = tf.spectral_loss(th(gm), torch.from_numpy(x0), torch.from_numpy(x_t),
                           torch.from_numpy(t))
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-4)


# ---- sampling ---------------------------------------------------------------------

@pytest.mark.parametrize('order', [1, 2])
@pytest.mark.parametrize('substeps', [1, 2])
@pytest.mark.parametrize('guidance', [0.0, 0.3])
def test_forward_test_matches_jax(order, substeps, guidance):
    """'mean' mode from the same noise, atol 1e-4; with guidance the
    conditioning is [uncond, cond] = [0, 1] so the halves differ."""
    test_cfg = dict(sampler='FlowEulerODE', num_timesteps=8,
                    output_mode='mean', order=order, num_substeps=substeps)
    jf, params, tf = gmflows(cond=True, test_cfg=test_cfg)
    noise = rand(30, 4, *HW, 2)
    kw_j, kw_t = {}, {}
    if guidance:
        cond = np.array([0.0] * 4 + [1.0] * 4, np.float32)
        kw_j['cond'], kw_t['cond'] = jnp.asarray(cond), torch.from_numpy(cond)
    want = jf.forward_test(params, jax.random.PRNGKey(9), jnp.asarray(noise),
                           guidance_scale=guidance, **kw_j)
    got = tf.forward_test(torch.from_numpy(noise), torch.Generator(),
                          guidance_scale=guidance, **kw_t)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_forward_test_sample_mode_by_moments():
    """'sample' mode draws components and noise: 4096 samples from the same
    noise, mean within 0.05 and std within 10% of JAX's."""
    test_cfg = dict(sampler='FlowEulerODE', num_timesteps=6,
                    output_mode='sample', order=1)
    jf, params, tf = gmflows(test_cfg=test_cfg)
    noise = rand(31, 4096, *HW, 2)
    want = np.asarray(jf.forward_test(params, jax.random.PRNGKey(10),
                                      jnp.asarray(noise)))
    got = tf.forward_test(torch.from_numpy(noise),
                          torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=0.05)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.1)


@pytest.mark.parametrize('guidance', [0.0, 0.3])
def test_forward_u_matches_jax(guidance):
    jf, params, tf = gmflows(cond=True)
    x, t = rand(32, 2, *HW, 2), np.array([300.0, 700.0], np.float32)
    kw_j, kw_t = {}, {}
    if guidance:
        cond = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
        kw_j['cond'], kw_t['cond'] = jnp.asarray(cond), torch.from_numpy(cond)
    want = jf.forward_u(params, jnp.asarray(x), jnp.asarray(t),
                        guidance_scale=guidance, **kw_j)
    got = tf.forward_u(torch.from_numpy(x), torch.from_numpy(t),
                       guidance_scale=guidance, **kw_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---- Diffusion2D on the checkerboard ----------------------------------------------

def test_checkerboard_data_matches_jax():
    j, t = JCheckerboard(n_rc=4, rotation=30.0, thickness=0.5), \
        CheckerboardData(n_rc=4, rotation=30.0, thickness=0.5)
    a = t.batch(np.random.default_rng(0), 256)['x']
    np.testing.assert_array_equal(
        a, j.batch(np.random.default_rng(0), 256)['x'])
    np.testing.assert_array_equal(t.log_prob_support(a),
                                  j.log_prob_support(a))
    plain = CheckerboardData(n_rc=4)
    assert plain.log_prob_support(plain.batch(
        np.random.default_rng(1), 512)['x']).all()


def test_diffusion2d_loss_matches_jax():
    """The checkerboard config's composition (hidden cut to 32 x 2): the
    JAX ``Diffusion2D.loss`` and the port's from the same weights and
    replayed draws, loss rel 1e-5."""
    model_cfg = dict(CKB_MODEL)
    model_cfg['diffusion'] = dict(CKB_MODEL['diffusion'], denoising=dict(
        CKB_MODEL['diffusion']['denoising'], hidden=(32, 32)))
    jm = JDiffusion2D(train_cfg=CKB_TRAIN_CFG, test_cfg=CKB_TEST_CFG,
                      **model_cfg)
    trainable, _ = jm.init_params(jax.random.PRNGKey(0))
    trainable = _jitter(trainable, 1)
    tm = Diffusion2D(train_cfg=CKB_TRAIN_CFG, test_cfg=CKB_TEST_CFG,
                     device='cpu', **model_cfg)
    load(tm.diffusion.denoising, trainable['diffusion'])
    x = CheckerboardData(n_rc=4).batch(np.random.default_rng(2), 16)['x']
    draws = []
    real_u, real_n = jax.random.uniform, jax.random.normal

    def rec(fn, kind):
        def f(*a, **k):
            out = fn(*a, **k)
            if not isinstance(out, jax.core.Tracer):
                draws.append((kind, np.asarray(out)))
            return out
        return f
    with mock.patch.object(jax.random, 'uniform', rec(real_u, 'uniform')), \
            mock.patch.object(jax.random, 'normal', rec(real_n, 'normal')):
        loss_j, _ = jm.loss(_map(jnp.asarray, trainable), {},
                            jax.random.PRNGKey(3), dict(x=jnp.asarray(x)))
    rand_fn, randn_fn, _ = _replaying(draws)
    with mock.patch.object(torch, 'rand', rand_fn), \
            mock.patch.object(torch, 'randn', randn_fn):
        loss, logs = tm.loss(dict(x=torch.from_numpy(x)), torch.Generator())
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)


def test_diffusion2d_trains_and_samples_on_the_checkerboard():
    """A few ``build_train_step`` steps of the checkerboard config on the
    CPU (full width, batch 64): finite losses and grad norms, the EMA a
    copy of the weights before its start iteration; then ``val_step`` with
    the EMA weights: finite samples, the same on a repeat from the same
    noise."""
    torch.manual_seed(0)
    model = Diffusion2D(train_cfg=CKB_TRAIN_CFG, test_cfg=CKB_TEST_CFG,
                        device='cpu', **CKB_MODEL)
    trainable, frozen = model.init_params()
    optimizers = build_optimizers(CKB_OPT, trainable)
    state = TrainState.create(torch.Generator().manual_seed(1), trainable,
                              frozen, optimizers, ema_keys=model.ema_keys)
    step = build_train_step(model, optimizers, model.train_cfg,
                            EmaConfig.from_hook_cfg(CKB_EMA))
    data = CheckerboardData(n_rc=4)
    rng = np.random.default_rng(2)
    start = {n: p.detach().clone() for n, p in trainable['diffusion'].items()}
    for _ in range(4):
        batch = dict(x=torch.from_numpy(data.batch(rng, 64)['x']))
        state, logs = step(state, batch)
        assert np.isfinite(float(logs['loss']))
        assert np.isfinite(logs['diffusion_grad_norm'])
        assert logs['per_sample_var'].shape == (64,)
    assert all(torch.equal(state.ema['diffusion'][n], p)
               for n, p in trainable['diffusion'].items())
    assert any(not torch.equal(p, start[n])
               for n, p in trainable['diffusion'].items())
    noise = torch.randn(256, 1, 1, 2, generator=torch.Generator())
    ema = {n: t + 0.01 for n, t in state.ema['diffusion'].items()}
    a = model.val_step(dict(noise=noise), None, ema=ema)
    b = model.val_step(dict(noise=noise), None, ema=ema)
    assert a.shape == (256, 1, 1, 2) and torch.isfinite(a).all()
    assert torch.equal(a, b)
    # the EMA weights were used and the model's own put back
    c = model.val_step(dict(noise=noise), None)
    assert not torch.equal(a, c)
    assert all(torch.equal(p, trainable['diffusion'][n])
               for n, p in model.init_params()[0]['diffusion'].items())
    assert data.log_prob_support(a.reshape(-1, 2).numpy()).mean() >= 0.0
