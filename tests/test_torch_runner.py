"""Port parity: the train step of arcflow_tpu_torch.runner (AdamW with a
per-key lr multiplier, clip and NaN skip, Karras EMA, gradient
accumulation) against the JAX runner and optax over 3 steps fed identical
gradients.

Both sides train the same small adapter under a linear loss,
``sum_p mean_b sum(p * g_b)``, so each step's gradient is the batch mean of
``g`` that the test chooses: a plain step, then a step with a NaN
(skipped), then one above ``max_norm`` (clipped). Tolerance rtol 1e-5,
atol 1e-7: the same fp32 AdamW arithmetic in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.runner import EmaConfig as JEmaConfig
from arcflow_tpu.runner import TrainState as JTrainState
from arcflow_tpu.runner import build_train_step as j_build_train_step
from arcflow_tpu.runner.ema import ema_momentum as j_ema_momentum
from arcflow_tpu.runner.optim import GradClipConfig as JClip
from arcflow_tpu.runner.optim import build_optimizers as j_build_optimizers
from arcflow_tpu.runner.optim import clip_and_skip as j_clip_and_skip
from arcflow_tpu.utils.pytree import flatten as j_flatten
from arcflow_tpu_torch.runner import (EmaConfig, GradClipConfig, TrainState,
                                      build_optimizers, build_train_step,
                                      clip_and_skip, ema_momentum)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = {'proj_out_loggamma.bias': (6,), 'blocks.ff.lora_a': (4, 3),
          'norm_out.modulation.weight': (5,)}
OPT_CFG = dict(diffusion=dict(
    type='AdamW', lr=1e-2, betas=(0.9, 0.95), weight_decay=0.01,
    paramwise_cfg=dict(custom_keys={'proj_out_loggamma': dict(lr_mult=0.1)})))
TRAIN_CFG = dict(diffusion_grad_clip=1.0, diffusion_grad_clip_begin_iter=1,
                 diffusion_grad_clip_skip_ratio=20.0)
EMA = dict(gamma=7.0, start_iter=1)   # karras, the JAX default policy too
# the EMA hook of configs/flux/arcflux_2nfe_k16.py
FLUX_EMA_HOOK = dict(type='ExponentialMovingAverageHookMod',
                     module_keys=('diffusion_ema',), interp_mode='lerp',
                     interval=1, start_iter=100, momentum_policy='karras',
                     momentum_cfg=dict(gamma=7.0), priority='VERY_HIGH')


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split('.')
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _grads(step, bs=2):
    """Per-sample gradients of step ``step``: a plain step, one NaN, then a
    norm far above max_norm (1.0) but under max_norm * skip_ratio."""
    rng = np.random.default_rng(10 + step)
    g = {k: rng.standard_normal((bs, *s)).astype(np.float32)
         for k, s in SHAPES.items()}
    if step == 1:
        g['blocks.ff.lora_a'][0, 1, 2] = np.nan
    if step == 2:
        g = {k: 4.0 * v for k, v in g.items()}
    return g


class JaxLinearModel:
    def loss(self, trainable, frozen, rng, batch, running_status=None):
        flat = j_flatten(trainable['diffusion'])
        loss = sum(jnp.sum(flat[k][None] * batch[k]) / batch[k].shape[0]
                   for k in flat)
        return loss, {}


class PortLinearModel:
    def loss(self, batch, generator, running_status=None):
        loss = sum((self.params[k][None] * batch[k]).sum() / batch[k].shape[0]
                   for k in self.params)
        return loss, {}


def _init():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize('accum', [1, 2])
def test_train_step_matches_jax_runner_and_optax(accum):
    init = _init()
    j_train = {'diffusion': _unflatten({k: jnp.asarray(v)
                                        for k, v in init.items()})}
    j_opts = j_build_optimizers(OPT_CFG, j_train)
    j_state = JTrainState.create(jax.random.PRNGKey(0), j_train, {}, j_opts,
                                 ema_keys=('diffusion',))
    j_step = j_build_train_step(JaxLinearModel(), j_opts, TRAIN_CFG,
                                JEmaConfig(**EMA), grad_accum_steps=accum,
                                donate=False)

    model = PortLinearModel()
    model.params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for k, v in init.items()}
    t_train = {'diffusion': model.params}
    t_opts = build_optimizers(OPT_CFG, t_train)
    t_state = TrainState.create(torch.Generator(), t_train, {}, t_opts,
                                ema_keys=('diffusion',))
    t_step = build_train_step(model, t_opts, TRAIN_CFG, EmaConfig(**EMA),
                              grad_accum_steps=accum)

    for step in range(3):
        g = _grads(step)
        j_state, j_logs = j_step(j_state, {k: jnp.asarray(v)
                                           for k, v in g.items()})
        t_state, t_logs = t_step(t_state, {k: torch.from_numpy(v)
                                           for k, v in g.items()})
        assert t_state.step == int(j_state.step) == step + 1
        assert t_logs['diffusion_skipped'] == float(
            j_logs['diffusion_skipped']) == float(step == 1)
        np.testing.assert_allclose(t_logs['diffusion_grad_norm'],
                                   float(j_logs['diffusion_grad_norm']),
                                   **TOL)
        j_params = j_flatten(j_state.trainable['diffusion'])
        j_ema = j_flatten(j_state.ema['diffusion'])
        for k in SHAPES:
            np.testing.assert_allclose(
                t_state.trainable['diffusion'][k].detach().numpy(),
                np.asarray(j_params[k]), **TOL)
            np.testing.assert_allclose(t_state.ema['diffusion'][k].numpy(),
                                       np.asarray(j_ema[k]), **TOL)
    # the skipped step did not count: two Adam updates
    assert all(s['step'] == 2 for s in t_state.opt_states['diffusion'].values())


def test_lr_mult_goes_to_the_matching_parameters_only():
    params = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in SHAPES.items()}
    opt = build_optimizers(OPT_CFG, {'diffusion': params})['diffusion']
    lrs = {id(p): g['lr'] for g in opt.param_groups for p in g['params']}
    assert lrs[id(params['proj_out_loggamma.bias'])] == pytest.approx(1e-3)
    assert lrs[id(params['blocks.ff.lora_a'])] == 1e-2
    assert lrs[id(params['norm_out.modulation.weight'])] == 1e-2


@pytest.mark.parametrize('iteration,scale', [(0, 1.0), (5, 1.0), (5, 40.0),
                                             (5, np.nan)])
def test_clip_and_skip_matches_jax(iteration, scale):
    """Before begin_iter (unclipped), clipped, past max_norm * skip_ratio
    (skipped) and non-finite (skipped, NaNs zeroed)."""
    rng = np.random.default_rng(iteration)
    grads = [rng.standard_normal(s).astype(np.float32) * 0.5
             for s in SHAPES.values()]
    grads[1][0, 0] *= scale
    j_cfg, t_cfg = JClip(1.0, 2, 20.0), GradClipConfig(1.0, 2, 20.0)
    j_g, j_norm, j_skip = j_clip_and_skip([jnp.asarray(g) for g in grads],
                                          jnp.asarray(iteration), j_cfg)
    t_g, t_norm, t_skip = clip_and_skip([torch.from_numpy(g.copy())
                                         for g in grads], iteration, t_cfg)
    assert t_skip == bool(j_skip)
    np.testing.assert_allclose(float(t_norm), float(j_norm), **TOL)
    for a, b in zip(t_g, j_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_karras_ema_momentum_matches_jax():
    cfg = dict(gamma=7.0, start_iter=100)
    for it in (0, 99, 100, 101, 150, 5000):
        np.testing.assert_allclose(
            ema_momentum(EmaConfig(**cfg), it),
            float(j_ema_momentum(JEmaConfig(**cfg), jnp.asarray(it))),
            rtol=1e-6)


def test_ema_hook_cfg_of_the_flux_config_matches_jax():
    port, ref = (EmaConfig.from_hook_cfg(FLUX_EMA_HOOK),
                 JEmaConfig.from_hook_cfg(FLUX_EMA_HOOK))
    assert (port.gamma, port.start_iter) == (ref.gamma, ref.start_iter)
    assert ref.momentum_policy == 'karras' and ref.interval == 1
    for it in (0, 100, 101, 2000):
        np.testing.assert_allclose(
            ema_momentum(port, it),
            float(j_ema_momentum(ref, jnp.asarray(it))), rtol=1e-6)


@pytest.mark.parametrize('override', [
    dict(interp_mode='slerp'), dict(momentum_policy='fixed'),
    dict(interval=2), dict(momentum_cfg=dict(gamma=7.0, max_momentum=0.999))])
def test_ema_hook_cfg_refuses_what_is_not_ported(override):
    with pytest.raises(ValueError, match='only'):
        EmaConfig.from_hook_cfg(dict(FLUX_EMA_HOOK, **override))


def test_build_optimizers_refuses_another_type_or_submodule():
    params = {'diffusion': {k: torch.nn.Parameter(torch.zeros(s))
                            for k, s in SHAPES.items()}}
    with pytest.raises(ValueError, match='only AdamW'):
        build_optimizers(dict(diffusion=dict(type='SGD', lr=1.0)), params)
    with pytest.raises(KeyError, match='unknown submodule'):
        build_optimizers(dict(teacher=dict(type='AdamW', lr=1.0)), params)
