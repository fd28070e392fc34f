"""Port parity: the toy denoisers, GaussianFlow's training loss and sampler,
ArcFlow's data-based loss and the 2-D distillation, against the JAX package.

The flax modules are initialised, their params jittered (so zero-initialised
heads are live) and carried over with ``jax_params_to_torch`` under
``strict=True``. Random draws are replayed as in ``test_torch_train.py``: the
JAX function runs with ``jax.random.uniform``/``normal`` recording their
concrete outputs (under ``jax.disable_jit`` where they sit inside a
``lax.scan``), and the port's ``torch.rand``/``torch.randn`` return them in
the same order. Tolerances: module outputs 1e-5 absolute, losses 1e-5
relative, samples 1e-4 absolute (an fp32 loop of 16-32 steps whose sums
differ in order); the 2-NFE distillation loss 1e-4 relative, as in
``test_torch_train.py`` (two segments of rollouts, each integrating the
student's mixture over 128 substeps, carry the sums' rounding further; the
teacher's u alone agrees within 3e-6). All fp32.
"""

import contextlib
import copy
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from arcflow_tpu.diffusion import ArcFlowImitation as JImitation
from arcflow_tpu.diffusion import GaussianFlow as JGaussianFlow
from arcflow_tpu.models import ToyArcFlowDenoiser as JArcDenoiser
from arcflow_tpu.models import ToyMLPDenoiser as JMLPDenoiser
from arcflow_tpu.models.base import Distillation2D as JDistillation2D
from arcflow_tpu.utils.quantize import (quantize_weights_int4 as
                                        j_quantize_int4)
from arcflow_tpu.utils.quantize import (quantize_weights_int8 as
                                        j_quantize_int8)
from arcflow_tpu_torch import Config
from arcflow_tpu_torch.diffusion import ArcFlowImitation, GaussianFlow
from arcflow_tpu_torch.models import (Distillation2D, ToyArcFlowDenoiser,
                                      ToyMLPDenoiser)
from arcflow_tpu_torch.models.toy import fourier_features
from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)

ATOL, LOSS_RTOL, SAMPLE_ATOL, DISTILL_RTOL = 1e-5, 1e-5, 1e-4, 1e-4
HIDDEN = (32, 32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = dict(type='DiffusionMSELoss',
            data_info=dict(pred='u_t_pred', target='u_t'),
            rescale_cfg=dict(scale=30.0))


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _jitter(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return _map(lambda x: np.asarray(x) + scale * rng.standard_normal(
        np.shape(x)).astype(np.float32), jax.device_get(tree))


def flax_params(module, seed=0, c=2, **kwargs):
    params = jax.jit(module.init)(jax.random.PRNGKey(seed),
                                  jnp.zeros((2, c)), jnp.zeros((2,)),
                                  **kwargs)['params']
    return _jitter(params, seed + 100)


def load(module, params):
    module.load_state_dict(jax_params_to_torch(params), strict=True)
    return module


@contextlib.contextmanager
def recording(draws):
    """Record the concrete outputs of jax.random.uniform / normal."""
    real = dict(uniform=jax.random.uniform, normal=jax.random.normal)

    def make(kind):
        def fn(*args, **kwargs):
            out = real[kind](*args, **kwargs)
            if not isinstance(out, jax.core.Tracer):
                draws.append((kind, np.asarray(out)))
            return out
        return fn
    with mock.patch.object(jax.random, 'uniform', make('uniform')), \
            mock.patch.object(jax.random, 'normal', make('normal')):
        yield


@contextlib.contextmanager
def replaying(draws):
    """torch.rand / torch.randn returning ``draws`` in order, checking
    kind and shape; every draw must be used."""
    it = iter(draws)

    def make(kind):
        def fn(*size, generator=None, device=None, dtype=None, **kwargs):
            if len(size) == 1 and not isinstance(size[0], int):
                size = tuple(size[0])
            got, x = next(it)
            assert (got, x.shape) == (kind, tuple(size))
            return torch.from_numpy(np.array(x, np.float32)).to(device)
        return fn
    with mock.patch.object(torch, 'rand', make('uniform')), \
            mock.patch.object(torch, 'randn', make('normal')):
        yield
    assert next(it, None) is None, 'not every JAX draw was used'


class JCond(fnn.Module):
    """A denoiser whose output depends on a per-sample condition."""
    inner: fnn.Module

    def __call__(self, x_t, t, cond):
        return self.inner(x_t + cond[:, None], t)


class TCond(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x_t, t, cond):
        return self.inner(x_t + cond[:, None], t)


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ---- the denoisers ------------------------------------------------------------

def test_fourier_features_match_jax():
    from arcflow_tpu.models.toy import fourier_features as j_ff
    x = rand(0, 7, 2)
    for n in (0, 1, 6):
        np.testing.assert_allclose(
            fourier_features(torch.from_numpy(x), n).numpy(),
            np.asarray(j_ff(jnp.asarray(x), n)), atol=ATOL)


@pytest.mark.parametrize('freqs', [0, 6])
@pytest.mark.parametrize('kind', ['mlp', 'arcflow'])
def test_toy_denoisers_match_jax(kind, freqs):
    j_cls, t_cls = dict(mlp=(JMLPDenoiser, ToyMLPDenoiser),
                        arcflow=(JArcDenoiser, ToyArcFlowDenoiser))[kind]
    jm = j_cls(hidden=HIDDEN, fourier_freqs=freqs)
    params = flax_params(jm)
    tm = load(t_cls(hidden=HIDDEN, fourier_freqs=freqs, device='cpu'),
              params)
    x, t = rand(1, 9, 2), np.linspace(0, 1000, 9).astype(np.float32)
    want = jm.apply({'params': params}, jnp.asarray(x), jnp.asarray(t))
    got = tm(torch.from_numpy(x), torch.from_numpy(t))
    want, got = (want, got) if isinstance(want, dict) \
        else (dict(u=want), dict(u=got))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=ATOL)


def test_arcflow_denoiser_init_contract():
    """Zero heads, log-spaced loggamma rates in [0.2, 4], means bias of
    std 0.1: the JAX init's deterministic parts."""
    tm = ToyArcFlowDenoiser(num_gaussians=5, hidden=(16,), device='cpu')
    j = jax.jit(JArcDenoiser(num_gaussians=5, hidden=(16,)).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 2)), jnp.zeros((2,)))['params']
    for name in ('proj_out_means', 'proj_out_logweights', 'proj_out_loggamma'):
        assert not getattr(tm, name).weight.any()
    np.testing.assert_allclose(tm.proj_out_loggamma.bias.detach().numpy(),
                               np.asarray(j['proj_out_loggamma']['bias']),
                               rtol=1e-6)
    assert tm.proj_out_means.bias.abs().max() < 1.0


# ---- GaussianFlow ----------------------------------------------------------------

def flows(cond=False, test_cfg=None, train_cfg=None):
    """(JAX GaussianFlow, its params, port GaussianFlow), same weights."""
    j_den = JMLPDenoiser(hidden=HIDDEN, fourier_freqs=2)
    t_den = ToyMLPDenoiser(hidden=HIDDEN, fourier_freqs=2, device='cpu')
    if cond:
        j_den, t_den = JCond(j_den), TCond(t_den)
    params = flax_params(j_den, cond=jnp.zeros((2,))) if cond \
        else flax_params(j_den)
    load(t_den, params)
    kw = dict(num_timesteps=1000, test_cfg=test_cfg or {},
              train_cfg=train_cfg or {})
    jf = JGaussianFlow(denoising=j_den, flow_loss=dict(LOSS), **kw)
    tf = GaussianFlow(denoising=t_den, flow_loss=dict(LOSS), **kw)
    return jf, params, tf


def test_gaussian_flow_forward_train_matches_jax():
    jf, params, tf = flows()
    x0 = rand(2, 16, 2)
    draws = []
    with recording(draws):
        loss_j, logs_j = jf.forward_train(params, jax.random.PRNGKey(3),
                                          jnp.asarray(x0))
    assert [k for k, _ in draws] == ['uniform', 'normal']
    with replaying(draws):
        loss, logs = tf.forward_train(torch.Generator(), torch.from_numpy(x0))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(logs['per_sample_loss'].numpy(),
                               np.asarray(logs_j['per_sample_loss']),
                               rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(logs['timesteps'].numpy(),
                               np.asarray(logs_j['timesteps']), rtol=1e-6)


@pytest.mark.parametrize('orthogonal, interval', [
    (False, None), (True, None), (False, (300, 700)), (True, (0, 500))],
    ids=['cfg', 'orthogonal', 'interval', 'orthogonal_interval'])
def test_gaussian_flow_forward_u_cfg_matches_jax(orthogonal, interval):
    test_cfg = dict(orthogonal_guidance=orthogonal)
    if interval is not None:
        test_cfg['guidance_interval'] = list(interval)
    jf, params, tf = flows(cond=True, test_cfg=test_cfg)
    x = rand(4, 6, 2)
    t = np.array([50., 250., 400., 600., 800., 990.], np.float32)
    cond = np.concatenate([np.zeros(6, np.float32), rand(5, 6)])
    want = jf.forward_u(params, jnp.asarray(x), jnp.asarray(t),
                        guidance_scale=3.0, cond=jnp.asarray(cond))
    got = tf.forward_u(torch.from_numpy(x), torch.from_numpy(t),
                       guidance_scale=3.0, cond=torch.from_numpy(cond))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    plain = tf.forward_u(torch.from_numpy(x), torch.from_numpy(t),
                         cond=torch.from_numpy(cond[6:]))
    assert not torch.allclose(got, plain)


@pytest.mark.parametrize('sampler, guidance', [
    ('FlowEulerODE', 1.0), ('FlowEulerODE', 2.5), ('FlowSDE', 1.0),
    ('FlowSDE', 2.5)])
def test_gaussian_flow_forward_test_matches_jax(sampler, guidance):
    """The scheduler-driven sampler, with CFG in its orthogonal and interval
    forms when guided; the SDE's per-step normal draws replayed."""
    test_cfg = dict(sampler=sampler, num_timesteps=16, shift=2.0,
                    orthogonal_guidance=True, guidance_interval=[100, 800])
    if sampler == 'FlowSDE':
        test_cfg['sampler_kwargs'] = dict(h=0.7)
    jf, params, tf = flows(cond=True, test_cfg=test_cfg)
    noise = rand(6, 32, 2)
    cond = np.concatenate([np.zeros(32, np.float32), rand(7, 32)]) \
        if guidance > 1 else rand(7, 32)
    draws = []
    with recording(draws), jax.disable_jit():
        want = jf.forward_test(params, jax.random.PRNGKey(8),
                               jnp.asarray(noise), guidance_scale=guidance,
                               cond=jnp.asarray(cond))
    assert len(draws) == (16 if sampler == 'FlowSDE' else 0)
    with replaying(draws):
        got = tf.forward_test(torch.from_numpy(noise), torch.Generator(),
                              guidance_scale=guidance,
                              cond=torch.from_numpy(cond))
    assert got.shape == noise.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLE_ATOL)


# ---- ArcFlow, data-based ------------------------------------------------------------

def analytic_teacher(mod):
    """Exact u of N(mu, 0.25^2 I) data (tests/test_arcflow_train.py), in
    ``mod`` (jnp or torch)."""
    mu = mod.asarray([1.5, -0.5]) if mod is jnp \
        else torch.tensor([1.5, -0.5])

    def fn(x_t, t):
        s2 = 0.25 ** 2
        sigma = (t / 1000.0).reshape(-1, 1)
        alpha = 1 - sigma
        var_t = alpha ** 2 * s2 + sigma ** 2
        x0_hat = mu + alpha * s2 / var_t * (x_t - alpha * mu)
        eps_hat = sigma * (x_t - alpha * mu) / var_t
        return eps_hat - x0_hat
    return fn


def imitations(nfe=2, timestep_ratio=1.0):
    j_den = JArcDenoiser(num_gaussians=4, hidden=HIDDEN)
    params = flax_params(j_den)
    t_den = load(ToyArcFlowDenoiser(num_gaussians=4, hidden=HIDDEN,
                                    device='cpu'), params)
    kw = dict(num_timesteps=1000, train_cfg=dict(
        nfe=nfe, timestep_ratio=timestep_ratio, total_substeps=128,
        num_intermediate_states=3, window_substeps=3, gm_dropout=0.2,
        num_decay_iters=100))
    return (JImitation(denoising=j_den, flow_loss=dict(LOSS), **kw), params,
            ArcFlowImitation(denoising=t_den, flow_loss=dict(LOSS), **kw))


@pytest.mark.parametrize('nfe, ratio', [(2, 1.0), (4, 0.5)])
def test_arcflow_sample_t_matches_jax(nfe, ratio):
    jd, _, td = imitations(nfe, ratio)
    draws = []
    with recording(draws):
        want = jd.sample_t(jax.random.PRNGKey(0), 64)
    with replaying(draws):
        got = td.sample_t(torch.Generator(), 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    # raw t snapped to the NFE grid's segment sources
    base = 1.0 / (nfe - 1 + ratio)
    grid = (np.arange(1, nfe + 1) - (1 - ratio)) * base
    assert (np.abs(got[0].numpy()[:, None] - grid).min(axis=1) < 1e-5).all()


@pytest.mark.parametrize('iteration', [0, 50, 200])
def test_arcflow_imitation_forward_train_matches_jax(iteration):
    """The data-based loss and its gradients (the JAX contract of
    tests/test_arcflow_train.py::test_databased_imitation_forward_train)."""
    jd, params, td = imitations()
    x0 = rand(3, 8, 2, scale=0.3) + np.array([1.5, -0.5], np.float32)
    draws = []

    def j_loss(p):
        return jd.forward_train(p, jax.random.PRNGKey(4), jnp.asarray(x0),
                                teacher_fn=analytic_teacher(jnp),
                                running_status=dict(iteration=iteration))
    with recording(draws):
        (loss_j, logs_j), grads_j = jax.value_and_grad(j_loss, has_aux=True)(
            _map(jnp.asarray, params))
    # t, noise, GM dropout, student and teacher intervals
    assert [k for k, _ in draws] == ['uniform', 'normal'] + ['uniform'] * 3
    with replaying(draws):
        loss, logs = td.forward_train(torch.Generator(), torch.from_numpy(x0),
                                      teacher_fn=analytic_teacher(torch),
                                      running_status=dict(iteration=iteration))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    if iteration < 100:
        np.testing.assert_allclose(float(logs['teacher_ratio']),
                                   float(logs_j['teacher_ratio']), rtol=1e-6)
    got = dict(td.denoising.named_parameters())
    for k, g in jax_params_to_torch(jax.device_get(grads_j)).items():
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(),
                                   rtol=1e-3, atol=1e-5)


# ---- Distillation2D ------------------------------------------------------------------

def distill_cfg():
    cfg = Config.fromfile(os.path.join(
        REPO, 'configs/toy/checkerboard_arcflow_2nfe.py')).to_dict()
    model = cfg['model']
    model['diffusion']['denoising']['hidden'] = HIDDEN
    model['teacher']['denoising']['hidden'] = HIDDEN
    model.pop('teacher_ckpt')
    model.pop('type')
    return model, cfg['train_cfg'], cfg['test_cfg']


def _save_teacher(directory, teacher_params):
    """A checkpoint of the port's format holding the teacher as EMA and a
    decoy as the raw weights (the EMA must win)."""
    decoy = _map(np.zeros_like, teacher_params)
    os.makedirs(os.path.join(directory, '7'))
    torch.save(dict(step=7,
                    trainable={'diffusion': jax_params_to_torch(decoy)},
                    ema={'diffusion': jax_params_to_torch(teacher_params)}),
               os.path.join(directory, '7', 'state.pt'))


@pytest.mark.parametrize('quant', [None, 'int8', 'int4'])
def test_distillation2d_loss_matches_jax(tmp_path, quant):
    model, train_cfg, test_cfg = distill_cfg()
    jm = JDistillation2D(train_cfg=train_cfg, test_cfg=test_cfg,
                         **copy.deepcopy(model))
    trainable, _ = jm.init_params(jax.random.PRNGKey(0))
    student = _jitter(trainable['diffusion'], 1)
    teacher = _jitter(jm.teacher.denoising.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 2)), jnp.zeros((1,)))['params'],
        3, scale=0.2)
    frozen = {'teacher': _map(jnp.asarray, teacher)}
    if quant == 'int8':
        frozen['teacher'], frozen['teacher_quant'] = j_quantize_int8(
            frozen['teacher'], min_size=1024)
    elif quant == 'int4':
        frozen['teacher'], frozen['teacher_quant'] = j_quantize_int4(
            frozen['teacher'], min_size=1024, group_size=32)
    _save_teacher(str(tmp_path / 'ckpt'), teacher)
    tm = Distillation2D(train_cfg=train_cfg, test_cfg=test_cfg, device='cpu',
                        teacher_ckpt=str(tmp_path / 'ckpt'),
                        teacher_quant=quant, **copy.deepcopy(model))
    load(tm.diffusion.denoising, student)
    t_frozen = tm.init_params()[1]['teacher']
    assert not any(t.requires_grad for t in t_frozen.values())
    if quant is not None:
        kind = dict(int8='kernel', int4='kernel_packed4')[quant]
        assert any(n.endswith(kind) for n in t_frozen)
    x = np.random.default_rng(5).standard_normal((16, 2)).astype(np.float32)
    draws = []
    with recording(draws):
        loss_j, _ = jm.loss(dict(diffusion=_map(jnp.asarray, student)),
                            frozen, jax.random.PRNGKey(6),
                            dict(x=jnp.asarray(x)),
                            running_status=dict(iteration=150))
    with replaying(draws):
        loss, logs = tm.loss(dict(x=torch.from_numpy(x)), torch.Generator(),
                             running_status=dict(iteration=150))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=DISTILL_RTOL)
    assert 'loss_diffusion_step1' in logs
