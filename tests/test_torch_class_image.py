"""Port parity: ``LatentDiffusionClassImage`` (``models/class_image.py``),
both ``configs/imagenet`` files through the port's trainer and CLI, and
``apis/inference.py:init_model``, against the JAX package.

Both configs load unchanged, cut to ``tests/test_e2e_imagenet.py``'s
``_tiny_overrides`` (base 32, mult (1, 2), 1 res block, attention at 4, 4
heads, 8 x 8 x 4 latents, 4 classes). The losses take random weights drawn
for the JAX trees (``test_torch_unet.py:random_flax_params``, so every
head is live) carried over with ``jax_params_to_torch`` under
``strict=True``; JAX's draws are recorded and replayed into the port's
``torch.rand`` / ``torch.randn`` in order, as in ``test_torch_train.py``,
with the JAX denoisers' ``apply`` under ``jax.jit``. Tolerance: relative
1e-5 on every loss, fp32.
"""

import contextlib
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.apis.inference import init_model as j_init_model
from arcflow_tpu.apis.train import build_model_from_cfg as j_build_model
from arcflow_tpu.config import Config as JConfig
from arcflow_tpu.runner import TrainState as JTrainState
from arcflow_tpu_torch import Config
from arcflow_tpu_torch.apis import build_model_from_cfg, init_model
from arcflow_tpu_torch.apis import train_model
from arcflow_tpu_torch.pipelines import jax_params_to_torch
from arcflow_tpu_torch.runner import load_raw_checkpoint
from test_e2e_imagenet import N_CLASSES, _tiny_overrides, _write_latents
from test_torch_unet import random_flax_params


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW = os.path.join(REPO, 'configs/imagenet/imagenet256_flow.py')
DISTILL = os.path.join(REPO, 'configs/imagenet/imagenet256_arcflow_2nfe.py')
LOSS_RTOL = 1e-5
TEACHER_TINY = {f'model.teacher.denoising.{k}': v for k, v in dict(
    base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
    attn_resolutions=(4,), num_classes=N_CLASSES, num_heads=4).items()}


def overrides(path, **extra):
    """``test_e2e_imagenet.py``'s cuts of ``path`` (the distillation's
    teacher too, and 4 Gaussians)."""
    out = dict(_tiny_overrides())
    if path == DISTILL:
        out.update(TEACHER_TINY)
        out['model.diffusion.denoising.num_gaussians'] = 4
    out.update(extra)
    return out


def configs(path, **extra):
    """(JAX config, port config) of ``path`` with the same overrides."""
    opts = overrides(path, **extra)
    out = []
    for cls in (JConfig, Config):
        cfg = cls.fromfile(path)
        cfg.merge_from_dict(dict(opts))
        out.append(cfg)
    return out


_APPLY = {}


def jitted_pred(flow):
    """``flow.pred`` with the flax ``apply`` under ``jax.jit`` (one
    compile per module configuration and shape, shared by the tests): the
    loss's own draws stay eager and recorded."""
    module = flow.denoising
    if module not in _APPLY:
        _APPLY[module] = jax.jit(module.apply)
    apply = _APPLY[module]

    def pred(params, x_t, t, **kwargs):
        t = jnp.asarray(t, jnp.float32)
        if t.ndim == 0:
            t = jnp.broadcast_to(t, (x_t.shape[0],))
        return apply({'params': params}, x_t, t, **kwargs)
    return pred


def jax_loss(model, trainable, frozen, batch, iteration):
    draws = []
    real = dict(uniform=jax.random.uniform, normal=jax.random.normal)

    def recording(kind):
        def fn(*args, **kwargs):
            out = real[kind](*args, **kwargs)
            if not isinstance(out, jax.core.Tracer):
                draws.append((kind, np.asarray(out)))
            return out
        return fn
    with contextlib.ExitStack() as stack:
        for kind in ('uniform', 'normal'):
            stack.enter_context(mock.patch.object(jax.random, kind,
                                                  recording(kind)))
        for flow in (model.diffusion, model.teacher):
            if flow is not None:
                stack.enter_context(mock.patch.object(flow, 'pred',
                                                      jitted_pred(flow)))
        loss, log_vars = model.loss(
            trainable, frozen, jax.random.PRNGKey(3),
            {k: jnp.asarray(v) for k, v in batch.items()},
            running_status=dict(iteration=iteration))
    return float(loss), jax.device_get(log_vars), draws


def replaying(draws):
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


def make_batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return dict(latents=rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
                label=np.array([0, 3, 1, 2][:b], np.int32))


def student_teacher_params(jm):
    trainable = {'diffusion': random_flax_params(jm.diffusion.denoising, 11)}
    frozen = {} if jm.teacher is None else {
        'teacher': random_flax_params(jm.teacher.denoising, 12)}
    return trainable, frozen


@pytest.mark.parametrize('case', ['flow', 'distill', 'distill_cfg'])
def test_loss_matches_jax(case):
    """The flow loss (label dropout on: ``prob_class`` 0.5), and the 2-NFE
    distillation loss with the teacher at guidance 1.0 and at the config's
    CFG 1.5 (the teacher batch ``cat([null, label])``)."""
    if case == 'flow':
        j_cfg, t_cfg = configs(FLOW, **{'model.prob_class': 0.5})
    else:
        gs = 1.5 if case == 'distill_cfg' else 1.0
        j_cfg, t_cfg = configs(DISTILL, **{
            'model.teacher_ckpt': None,
            'model.student_init_from_teacher': False,
            'train_cfg.teacher_guidance_scale': gs,
            'train_cfg.total_substeps': 32})
    jm = j_build_model(j_cfg)
    trainable, frozen = student_teacher_params(jm)
    batch = make_batch()
    j_loss, j_logs, draws = jax_loss(jm, trainable, frozen, batch, 150)
    if case == 'flow':
        assert [k for k, _ in draws] == ['uniform', 'uniform', 'normal']

    tm = build_model_from_cfg(t_cfg, device='cpu')
    tm.diffusion.denoising.load_state_dict(
        jax_params_to_torch(trainable['diffusion']), strict=True)
    if tm.teacher is not None:
        tm.teacher.denoising.load_state_dict(
            jax_params_to_torch(frozen['teacher']), strict=True)
    rand, randn, rest = replaying(draws)
    with mock.patch.object(torch, 'rand', rand), \
            mock.patch.object(torch, 'randn', randn):
        loss, logs = tm.loss({k: torch.from_numpy(v)
                              for k, v in batch.items()},
                             torch.Generator(),
                             running_status=dict(iteration=150))
    assert next(rest, None) is None, 'not every JAX draw was used'
    np.testing.assert_allclose(loss.item(), j_loss, rtol=LOSS_RTOL)
    for key in j_logs:
        if key.startswith('loss_diffusion'):
            np.testing.assert_allclose(float(logs[key]), float(j_logs[key]),
                                       rtol=LOSS_RTOL)
    loss.backward()
    grads = [p.grad for p in tm.init_params()[0]['diffusion'].values()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_graft_matches_jax_but_for_its_noise():
    """The student's trunk copied from the teacher, the teacher's conv_out
    tiled over the K-way means head as JAX tiles it, and the bias noise of
    scale 0.05 (drawn from torch's generator, not JAX's key)."""
    j_cfg, t_cfg = configs(DISTILL, **{'model.teacher_ckpt': None,
                                       'model.student_init_from_teacher':
                                           False})
    jm = j_build_model(j_cfg)
    trainable, frozen = student_teacher_params(jm)
    student, teacher = trainable['diffusion'], frozen['teacher']
    want = jax_params_to_torch(jax.device_get(
        jm._graft_student_from_teacher(student, teacher,
                                       jax.random.PRNGKey(0))))
    tm = build_model_from_cfg(t_cfg, device='cpu')
    tm.diffusion.denoising.load_state_dict(jax_params_to_torch(student),
                                           strict=True)
    tm.teacher.denoising.load_state_dict(jax_params_to_torch(teacher),
                                         strict=True)
    torch.manual_seed(0)
    tm._graft_student_from_teacher()
    got = tm.diffusion.denoising.state_dict()
    assert set(got) == set(want)
    for name in want:
        if name != 'proj_out_means.bias':
            np.testing.assert_array_equal(got[name].numpy(),
                                          want[name].numpy(), err_msg=name)
    tiled = tm.teacher.denoising.conv_out.bias.repeat(4)
    noise = (got['proj_out_means.bias'] - tiled) / 0.05
    j_noise = (want['proj_out_means.bias'] - tiled) / 0.05
    assert 0.2 < noise.std() < 3 and 0.2 < j_noise.std() < 3
    assert not torch.equal(noise, j_noise)
    # the copies do not alias the teacher's storage
    assert got['conv_in.weight'].data_ptr() != \
        tm.teacher.denoising.conv_in.weight.data_ptr()


def test_student_cfg_is_refused_where_jax_fails_on_shapes():
    """JAX's val_step concatenates null labels for any guidance scale but
    0 and 1, and ArcFlow's sampler runs one batch, so an ArcFlow student's
    CFG fails on the doubled labels (``class_image.py:154-158``); the port
    refuses it by name. The teacher (a ``GaussianFlow``) samples with CFG."""
    _, t_cfg = configs(DISTILL, **{'model.teacher_ckpt': None,
                                   'test_cfg.total_substeps': 16})
    tm = build_model_from_cfg(t_cfg, device='cpu')
    with pytest.raises(ValueError, match='samples without CFG'):
        tm.val_step(dict(label=np.arange(2)), torch.Generator(),
                    guidance_scale=1.5)
    out = tm.val_step(dict(label=np.arange(2)), torch.Generator())
    assert out['pred_latents'].shape == (2, 8, 8, 4)
    _, f_cfg = configs(FLOW, **{'test_cfg.num_timesteps': 2})
    flow = build_model_from_cfg(f_cfg, device='cpu')
    out = flow.val_step(dict(label=np.arange(2)), torch.Generator(),
                        guidance_scale=2.0)
    assert torch.isfinite(out['pred_latents']).all()


def test_vae_branch_is_dead_as_in_jax():
    """A configured VAE never decodes in JAX: ``init_params``
    (``class_image.py:57-78``) never puts 'vae' into ``frozen``, so
    ``val_step``'s decode branch (``:159-162``) does not run and the result
    is latents. The port behaves so."""
    class NoDecode:
        def decode(self, *args):
            raise AssertionError('decoded')
    j_cfg, t_cfg = configs(FLOW, **{'test_cfg.num_timesteps': 2})
    jm = j_build_model(j_cfg)
    jm.vae = NoDecode()
    # a stub init and sampler: the branch, not the UNet, is under test
    with mock.patch.object(type(jm.diffusion.denoising), 'init',
                           lambda *a, **k: {'params': {'w': jnp.zeros(1)}}):
        trainable, frozen = jm.init_params(jax.random.PRNGKey(0))
    assert 'vae' not in frozen
    j_state = JTrainState.create(jax.random.PRNGKey(0), trainable, frozen)
    with mock.patch.object(jm.diffusion, 'forward_test',
                           lambda params, rng, noise, **kw: noise):
        j_out = jm.val_step(j_state, jax.random.PRNGKey(1),
                            dict(label=np.arange(2)))
    tm = build_model_from_cfg(t_cfg, device='cpu')
    tm.vae = NoDecode()
    assert 'vae' not in tm.init_params()[1]
    out = tm.val_step(dict(label=np.arange(2)), torch.Generator())
    assert set(out) == set(j_out) == {'num_samples', 'pred_latents'}


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """Both configs through ``train_model`` on the CPU, 2 iterations each,
    the distillation's teacher from the flow run's checkpoint."""
    tmp = tmp_path_factory.mktemp('imagenet')
    _write_latents(str(tmp / 'latents'), n_per_class=16)
    runs = {}
    for name, path, extra in (
            ('flow', FLOW, {}),
            ('distill', DISTILL, {'model.teacher_ckpt': str(
                tmp / 'flow' / 'checkpoints' / 'imagenet256_flow')})):
        cfg = Config.fromfile(path)
        cfg.merge_from_dict(overrides(path, **{
            'data.train.latents_dir': str(tmp / 'latents'),
            'total_iters': 2, 'checkpoint_config.interval': 2, **extra}))
        cfg.work_dir = str(tmp / name)
        state, model = train_model(cfg, seed=0, device='cpu')
        runs[name] = (cfg, state, model)
    return tmp, runs


def test_configs_train_through_train_model(trained):
    tmp, runs = trained
    for name, (cfg, state, model) in runs.items():
        assert state.step == 2, name
        raw = load_raw_checkpoint(os.path.join(cfg.work_dir, 'checkpoints',
                                               cfg.name))
        assert raw['step'] == 2 and set(raw['ema']) == {'diffusion'}
        for sub in (raw['trainable'], raw['ema']):
            assert all(torch.isfinite(t).all()
                       for t in sub['diffusion'].values())
    # the teacher holds the flow run's EMA; the student started from it
    flow_raw = load_raw_checkpoint(os.path.join(
        runs['flow'][0].work_dir, 'checkpoints', 'imagenet256_flow'))
    teacher = runs['distill'][2].teacher.denoising.state_dict()
    for n, t in flow_raw['ema']['diffusion'].items():
        assert torch.equal(teacher[n], t), n


def test_init_model_restores_the_ema(trained):
    """``init_model`` with ``ema_only`` makes the checkpoint's EMA the live
    weights and drops the EMA slot, as JAX does; without it the live
    weights are the trained ones and the slot holds the checkpoint's EMA,
    where JAX leaves its fresh init there (``apis/inference.py:48-50``)."""
    tmp, runs = trained
    cfg = runs['distill'][0]
    ckpt = os.path.join(cfg.work_dir, 'checkpoints', cfg.name)
    raw = load_raw_checkpoint(ckpt)
    model, state = init_model(cfg, ckpt, device='cpu')
    assert state.ema is None and state.step == 2
    live = model.diffusion.denoising.state_dict()
    for n, t in raw['ema']['diffusion'].items():
        assert torch.equal(live[n], t), n
    out = model.val_step(dict(label=np.arange(N_CLASSES)),
                         torch.Generator().manual_seed(0))
    assert out['pred_latents'].shape == (N_CLASSES, 8, 8, 4)
    assert torch.isfinite(out['pred_latents']).all()

    model, state = init_model(cfg, ckpt, ema_only=False, device='cpu')
    for n, t in raw['trainable']['diffusion'].items():
        assert torch.equal(state.trainable['diffusion'][n], t), n
        assert torch.equal(state.ema['diffusion'][n],
                           raw['ema']['diffusion'][n]), n


def test_jax_init_model_keeps_its_init_in_the_ema_slot():
    """The divergence named above, on JAX's side: with ``ema_only=False``
    its state's EMA is the fresh init (0.5 here), neither the checkpoint's
    EMA (2) nor its trained weights (1). Stubs stand in for the model and
    the checkpoint (JAX reads its own format)."""
    class Stub:
        ema_keys = ('diffusion',)

        def init_params(self, rng):
            return {'diffusion': {'w': jnp.full(3, 0.5)}}, {}
    raw = dict(step=2, trainable={'diffusion': {'w': np.ones(3)}},
               ema={'diffusion': {'w': np.full(3, 2.0)}})
    with mock.patch('arcflow_tpu.apis.inference.build_model_from_cfg',
                    return_value=Stub()), \
            mock.patch('arcflow_tpu.runner.checkpoint.load_raw_checkpoint',
                       return_value=raw):
        _, state = j_init_model(JConfig.fromfile(FLOW), checkpoint='ckpt',
                                ema_only=False)
    np.testing.assert_array_equal(state.trainable['diffusion']['w'], 1.0)
    np.testing.assert_array_equal(state.ema['diffusion']['w'], 0.5)


def test_distill_config_trains_through_the_cli(trained):
    """``python -m arcflow_tpu_torch.train --device cpu`` on the shipped
    distillation config, its teacher from the flow run's checkpoint."""
    tmp, runs = trained
    opts = dict(overrides(DISTILL, **{
        'data.train.latents_dir': str(tmp / 'latents'),
        'model.teacher_ckpt': str(tmp / 'flow' / 'checkpoints' /
                                  'imagenet256_flow'),
        'total_iters': 1, 'log_config.interval': 1,
        'data.train_dataloader.samples_per_gpu': 8}))
    args = [f'{k}={v!r}'.replace(' ', '') for k, v in opts.items()]
    res = subprocess.run(
        [sys.executable, '-m', 'arcflow_tpu_torch.train', DISTILL,
         '--device', 'cpu', '--work-dir', str(tmp / 'cli'),
         '--cfg-options', *args],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2'))
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-3000:]
    assert 'INFO device: cpu' in out and 'iter [1/1]' in out, out[-3000:]
