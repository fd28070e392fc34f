"""Port parity: the distillation loss of LatentDiffusionTextImage
(arcflow_tpu_torch.models.latent_diffusion) and its adapter gradients
against the JAX package, plus the port's own training invariants.

The tiny tied teacher/student of tests/test_latent_diffusion.py (``TINY_NET``)
is built on both sides in fp32; the JAX (trainable, frozen) pair, jittered
so the zero-initialised heads and LoRA are non-trivial, is carried into the
port with ``load_jax_latent_diffusion``. The JAX loss runs un-jitted under
``jax.value_and_grad``; its uniform and normal draws are recorded by
wrapping ``jax.random`` and replayed, in the same order, in place of the
port's ``torch.rand``/``torch.randn``. Tolerances: the loss within 1e-4
relative and each adapter gradient within 1e-3 relative L2, since both run
in fp32 and differ only in the order of their sums.
"""

import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.diffusion import integrator as j_integrator
from arcflow_tpu.diffusion.policies import ArcFlowPolicy as JPolicy
from arcflow_tpu.models import LatentDiffusionTextImage as JLatentDiffusion
from arcflow_tpu_torch.diffusion import integrator as t_integrator
from arcflow_tpu_torch.diffusion.policies import ArcFlowPolicy as TPolicy
from arcflow_tpu_torch.models import LatentDiffusionTextImage
from arcflow_tpu_torch.pipelines import (jax_params_to_torch,
                                         load_jax_latent_diffusion)
from arcflow_tpu_torch.runner import (EmaConfig, TrainState, build_optimizers,
                                      build_train_step)
from arcflow_tpu_torch.utils.pytree import flatten

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-3
# tests/test_latent_diffusion.py:12-46, in fp32
TINY_NET = dict(in_channels=16, num_layers=1, num_single_layers=2,
                attention_head_dim=16, num_attention_heads=4,
                joint_attention_dim=32, pooled_projection_dim=16,
                axes_dims_rope=(4, 6, 6), guidance_embeds=True,
                checkpointing=False)
TRAIN_CFG = dict(nfe=2, timestep_ratio=1.0, total_substeps=128,
                 num_intermediate_states=2, window_substeps=3,
                 gm_dropout=0.1, num_decay_iters=100,
                 distilled_guidance_scale=3.5,
                 teacher_distilled_guidance_scale=3.5,
                 teacher_guidance_scale=2.0)


def model_cfg(lora_dropout=0.0, checkpointing=False, cfg_scale=2.0):
    net = dict(TINY_NET, checkpointing=checkpointing)
    return dict(
        diffusion=dict(
            type='ArcFlowImitationDataFree',
            policy_type='ArcFlow',
            denoising=dict(type='ArcFluxTransformer2DModel', patch_size=2,
                           num_gaussians=4, lora_rank=4,
                           lora_dropout=lora_dropout, **net),
            flow_loss=dict(type='DiffusionMSELoss',
                           data_info=dict(pred='u_t_pred', target='u_t'),
                           rescale_cfg=dict(scale=30.0)),
            num_timesteps=1,
            timestep_sampler=dict(type='ContinuousTimeStepSampler',
                                  shift=3.2)),
        teacher=dict(
            type='GaussianFlow',
            denoising=dict(type='FluxTransformer2DModel', patch_size=2,
                           **net),
            num_timesteps=1),
        tie_teacher=True,
        latent_shape=(8, 8, 4),
        text_embed_dim=32, pooled_dim=16,
        train_cfg=dict(TRAIN_CFG, teacher_guidance_scale=cfg_scale),
        test_cfg=dict(nfe=2, timestep_ratio=1.0, total_substeps=128,
                      distilled_guidance_scale=3.5))


def jax_model(cfg):
    cfg = copy.deepcopy(cfg)
    for part in ('diffusion', 'teacher'):
        cfg[part]['denoising']['dtype'] = jnp.float32
    return JLatentDiffusion(**cfg)


def port_model(cfg, **kw):
    return LatentDiffusionTextImage(device='cpu', dtype=torch.float32,
                                    **copy.deepcopy(cfg), **kw)


def make_batch(bs=2, s_txt=6, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        latents=rng.standard_normal((bs, 8, 8, 4)).astype(f),
        prompt_embed_kwargs=dict(
            encoder_hidden_states=rng.standard_normal((bs, s_txt, 32)
                                                      ).astype(f),
            pooled_projections=rng.standard_normal((bs, 16)).astype(f)),
        negative_prompt_embed_kwargs=dict(
            encoder_hidden_states=np.zeros((bs, s_txt, 32), f),
            pooled_projections=np.zeros((bs, 16), f)))


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _jitter(tree, seed):
    rng = np.random.default_rng(seed)
    return _map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
        np.shape(x)).astype(np.float32), jax.device_get(tree))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope='module')
def jax_params():
    """The JAX pair, jittered: the adapter so its heads and LoRA are live,
    and the frozen trunk so the zero-initialised modulations are."""
    trainable, frozen = jax_model(model_cfg()).init_params(
        jax.random.PRNGKey(1))
    return _jitter(trainable, 7), _jitter(frozen, 8)


def _jax_loss_and_grads(cfg, trainable, frozen, batch, iteration):
    model = jax_model(cfg)
    jbatch = _map(jnp.asarray, batch)
    draws = []
    real = dict(uniform=jax.random.uniform, normal=jax.random.normal)

    def recording(kind):
        def fn(*args, **kwargs):
            out = real[kind](*args, **kwargs)
            # flax evaluates param initialisers abstractly during apply to
            # check shapes: those traced draws are not the loss's
            if not isinstance(out, jax.core.Tracer):
                draws.append((kind, np.asarray(out)))
            return out
        return fn

    def loss_fn(tr):
        return model.loss(tr, frozen, jax.random.PRNGKey(2), jbatch,
                          running_status=dict(iteration=iteration))

    with mock.patch.object(jax.random, 'uniform', recording('uniform')), \
            mock.patch.object(jax.random, 'normal', recording('normal')):
        (loss, log_vars), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            _map(jnp.asarray, trainable))
    return float(loss), log_vars, jax.device_get(grads), draws


def _replaying(draws):
    """torch.rand / torch.randn stand-ins that return the JAX draws in
    order, checking kind and shape."""
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


def _port_batch(batch):
    return _map(torch.from_numpy, batch)


@pytest.mark.parametrize('cfg_scale', [2.0, None], ids=['cfg', 'no_cfg'])
def test_loss_and_adapter_grads_match_jax(jax_params, cfg_scale):
    """CFG on (teacher batch of 2B, negative embeds first) and off."""
    trainable, frozen = jax_params
    cfg = model_cfg(cfg_scale=cfg_scale)
    batch = make_batch()
    j_loss, j_logs, j_grads, draws = _jax_loss_and_grads(
        cfg, trainable, frozen, batch, iteration=50)
    # noise, then per NFE step: GM dropout, student and teacher draws
    assert [k for k, _ in draws] == ['normal'] + ['uniform'] * 6

    model = port_model(cfg)
    load_jax_latent_diffusion(model, trainable, frozen)
    rand, randn, rest = _replaying(draws)
    with mock.patch.object(torch, 'rand', rand), \
            mock.patch.object(torch, 'randn', randn):
        loss, logs = model.loss(_port_batch(batch), torch.Generator(),
                                running_status=dict(iteration=50))
    assert next(rest, None) is None          # every draw was used
    loss.backward()
    np.testing.assert_allclose(loss.item(), j_loss, rtol=LOSS_RTOL)
    for key in ('loss_diffusion_step0', 'loss_diffusion_step1'):
        np.testing.assert_allclose(float(logs[key]), float(j_logs[key]),
                                   rtol=LOSS_RTOL)

    want = jax_params_to_torch(j_grads['diffusion'])
    got = model.init_params()[0]['diffusion']
    assert set(want) == set(got)
    for name, p in got.items():
        assert p.grad is not None, name
        assert _rel_l2(p.grad.numpy(), want[name].numpy()) <= GRAD_REL_L2, \
            (name, _rel_l2(p.grad.numpy(), want[name].numpy()))


def test_adapter_and_frozen_split_match_jax(jax_params):
    """The port splits parameters as the JAX package does, stores the
    adapter in fp32 and the trunk in ``frozen_dtype``."""
    trainable, frozen = jax_params
    model = port_model(model_cfg(), frozen_dtype='bfloat16')
    t_train, t_frozen = model.init_params()
    assert set(t_train['diffusion']) == set(
        jax_params_to_torch(trainable['diffusion']))
    assert set(t_frozen['base']) == set(jax_params_to_torch(frozen['base']))
    assert set(t_frozen['teacher_head']) == set(
        jax_params_to_torch(frozen['teacher_head']))
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in t_train['diffusion'].values())
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for sub in t_frozen.values() for p in sub.values())


def test_teacher_shares_the_student_trunk_and_has_no_lora():
    model = port_model(model_cfg())
    student = dict(model.diffusion.denoising.named_parameters())
    teacher = dict(model.teacher.denoising.named_parameters())
    assert not any('lora' in n for n in teacher)
    head = [n for n in teacher if n.startswith(('proj_out.', 'norm_out.'))]
    assert sorted(head) == ['norm_out.modulation.bias',
                            'norm_out.modulation.weight', 'proj_out.bias',
                            'proj_out.weight']
    for name, p in teacher.items():
        if name not in head:
            assert p is student[name], name
    # the student's norm_out is its own (adapter), not the teacher's head
    assert student['norm_out.modulation.weight'] is not \
        teacher['norm_out.modulation.weight']


def _port_grads(checkpointing, lora_dropout=0.1):
    torch.manual_seed(0)
    model = port_model(model_cfg(lora_dropout=lora_dropout,
                                 checkpointing=checkpointing))
    with torch.no_grad():                    # live heads and LoRA
        g = torch.Generator().manual_seed(3)
        for p in model.init_params()[0]['diffusion'].values():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    loss, _ = model.loss(_port_batch(make_batch()),
                         torch.Generator().manual_seed(4),
                         running_status=dict(iteration=10))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.init_params()[0]['diffusion'].items()}


def test_checkpointing_keeps_the_gradients_with_lora_dropout():
    """Each checkpointed block draws its dropout masks from a generator
    seeded by the step's seed and its index, so the recompute in the
    backward draws the same masks: the gradients equal those without
    checkpointing (up to fp32 rounding), and differ from a run without
    dropout."""
    loss_ref, ref = _port_grads(checkpointing=False)
    loss_ckpt, ckpt = _port_grads(checkpointing=True)
    assert loss_ckpt == loss_ref
    for name in ref:
        torch.testing.assert_close(ckpt[name], ref[name], rtol=1e-5,
                                   atol=1e-7)
    loss_plain, _ = _port_grads(checkpointing=False, lora_dropout=0.0)
    assert loss_plain != loss_ref


def test_lora_dropout_only_with_a_generator():
    """LoRA dropout is off without a generator (eval) and draws masks with
    one; a generator seeded alike draws the same masks."""
    from arcflow_tpu_torch.models.layers import LoRADense
    layer = LoRADense(8, 6, lora_rank=4, lora_dropout=0.5,
                      dtype=torch.float32)
    with torch.no_grad():
        layer.lora_b.normal_()
    x = torch.randn(3, 8)
    plain = layer(x)
    torch.testing.assert_close(layer(x), plain, rtol=0, atol=0)
    a = layer(x, torch.Generator().manual_seed(1))
    b = layer(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, plain)


def test_a_train_step_leaves_the_frozen_tensors_untouched():
    model = port_model(model_cfg(lora_dropout=0.05, checkpointing=True))
    trainable, frozen = model.init_params()
    frozen_before = {n: p.clone() for n, p in flatten(frozen).items()}
    train_before = {n: p.clone() for n, p in trainable['diffusion'].items()}
    optimizers = build_optimizers(dict(diffusion=dict(type='AdamW', lr=1e-3)),
                                  trainable)
    state = TrainState.create(torch.Generator().manual_seed(5), trainable,
                              frozen, optimizers, ema_keys=model.ema_keys)
    step = build_train_step(model, optimizers,
                            train_cfg=dict(diffusion_grad_clip=50.0),
                            ema_cfg=EmaConfig())
    state, logs = step(state, _port_batch(make_batch()))
    assert state.step == 1 and np.isfinite(float(logs['loss']))
    assert np.isfinite(logs['diffusion_grad_norm'])
    for name, p in flatten(state.frozen).items():
        assert torch.equal(p, frozen_before[name]), name
    assert any(not torch.equal(p, train_before[n])
               for n, p in state.trainable['diffusion'].items())


def _policy_pair(seed, b=3, k=4):
    rng = np.random.default_rng(seed)
    f = np.float32
    out = dict(means=rng.standard_normal((b, k, 4, 4, 2)).astype(f),
               logweights=rng.standard_normal((b, k, 4, 4, 1)).astype(f),
               loggammas=rng.standard_normal((b, k - 1, 4, 4, 1)).astype(f))
    x = rng.standard_normal((b, 4, 4, 2)).astype(f)
    sigma = np.array([0.9, 0.5, 0.3], f)
    jp = JPolicy.create({n: jnp.asarray(v) for n, v in out.items()},
                        jnp.asarray(x), jnp.asarray(sigma))
    tp = TPolicy.create({n: torch.from_numpy(v) for n, v in out.items()},
                        torch.from_numpy(x), torch.from_numpy(sigma))
    return jp, tp, x, sigma


def test_policy_average_u_matches_jax():
    """Long spans (closed-form mean) and spans under 2 substeps (local
    velocity), per sample; rtol 1e-5 for fp32 exponentials."""
    jp, tp, x, sigma = _policy_pair(0)
    raw_a = np.array([0.8, 0.5, 0.3], np.float32)
    raw_e = np.array([0.2, 0.495, 0.1], np.float32)     # middle: < 2 / 128
    sig_e = np.array([0.4, 0.49, 0.1], np.float32)
    j = j_integrator.policy_average_u(jp, jnp.asarray(x), jnp.asarray(sigma),
                                      jnp.asarray(sig_e), jnp.asarray(raw_a),
                                      jnp.asarray(raw_e), 128)
    t = t_integrator.policy_average_u(tp, torch.from_numpy(x),
                                      torch.from_numpy(sigma),
                                      torch.from_numpy(sig_e),
                                      torch.from_numpy(raw_a),
                                      torch.from_numpy(raw_e), 128)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)


def test_policy_dropout_and_detach():
    """The same uniforms drop the same components as in JAX, never all of
    a cell's; detach cuts the graph."""
    jp, tp, _, _ = _policy_pair(1)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (3, 4, 1, 1, 1)))
    u[0] = 0.0                                # all would drop: none may
    with mock.patch.object(jax.random, 'uniform',
                           lambda *a, **k: jnp.asarray(u)):
        j = jp.dropout(key, 0.3)
    with mock.patch.object(torch, 'rand',
                           lambda *a, **k: torch.from_numpy(u)):
        t = tp.dropout(torch.Generator(), 0.3)
    np.testing.assert_array_equal(t.logweights.numpy(),
                                  np.asarray(j.logweights))
    assert torch.isfinite(t.logweights[0]).all()
    lw = tp.logweights.clone().requires_grad_()
    assert not TPolicy(tp.means_u, lw, tp.loggammas, tp.x_t_src,
                       tp.sigma_t_src).detach().logweights.requires_grad


def test_loss_checks_the_batch_against_the_config():
    """Latents and prompt embeds that do not fit ``latent_shape``,
    ``text_embed_dim`` or ``pooled_dim`` are refused before any forward."""
    model = port_model(model_cfg())
    batch = _port_batch(make_batch())
    embeds = batch['prompt_embed_kwargs']
    for bad, match in [
            (dict(batch, latents=batch['latents'][:, :4]), 'latents'),
            (dict(batch, prompt_embed_kwargs=dict(
                embeds, pooled_projections=embeds['pooled_projections'][:, :8]
            )), 'prompt_embed_kwargs')]:
        with pytest.raises(ValueError, match=match):
            model.loss(bad, torch.Generator(), dict(iteration=0))
