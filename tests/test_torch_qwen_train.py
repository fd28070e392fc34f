"""Port parity: Qwen-Image distillation. The teacher
``QwenImageTransformer2DModel``, and the loss and adapter gradients of
``LatentDiffusionTextImage`` on the Qwen family, key-padded, with teacher
CFG, on a frozen trunk stored in bf16, int8 or int4, tied and untied,
against the JAX package; the tied teacher's storage, the shipped Qwen
configs at full width (on the meta device), ``val_step``, ``pretrained``
loading and ``train_model`` end to end.

The tiny Qwen pair is built on both sides in fp32 compute; the JAX
(trainable, frozen) pair, jittered so the zero-initialised heads and LoRA
are live, crosses over with ``load_jax_latent_diffusion``. Draws are
replayed as in ``tests/test_torch_train.py``. Tolerances: the loss within
1e-4 relative and each adapter gradient within 1e-3 relative L2 (both fp32,
differing in the order of their sums), the teacher's u within
``test_torch_qwen.py``'s 2e-4 / 2e-5.

``train_model`` trains a tiny int8-trunk Qwen config for two iterations from
an ``ImagePrompt`` in prompt mode whose prompts the native Qwen2.5 text
encoder (a tiny folder of random weights with ``test_torch_qwen_text.py``'s
tokenizer) embeds inside the loss:
with two ``size_idx`` buckets of two resolutions (64 and 48 pixels square,
latents of 8 x 8 and 6 x 6) it takes the bucketized loader, whose batches
reach the loss in the order of JAX's sampler for the same seed, each at
its bucket's size; with one bucket it takes the plain loader, as JAX's
``train_model`` does; without an EMA hook it keeps JAX's fixed 0.999 EMA.

``pretrained`` / ``pretrained_adapter`` and the teacher's
``pretrained_lora``: a Qwen teacher checkpoint and adapters written in
diffusers keys load into the port's composition as into JAX's: the frozen
trunk, the teacher's head and the tiled means head equal JAX's (the head's
bias noise aside, which each package draws from its own generator), fp32
on both sides, within 1e-6.
"""

import contextlib
import copy
import functools
import json
import textwrap
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.data import BucketizedBatchSampler as JSampler
from arcflow_tpu.models import LatentDiffusionTextImage as JLatentDiffusion
from arcflow_tpu.models.qwen import ArcQwenImageTransformer2DModel as JArcQwen
from arcflow_tpu.models.qwen import QwenImageTransformer2DModel as JTeacher
from arcflow_tpu.pipelines import flax_to_torch_flux
from arcflow_tpu.pipelines import save_adapter_state as j_save_adapter
from arcflow_tpu.runner import TrainState as JTrainState
from arcflow_tpu.utils.pytree import flatten as j_flatten
from arcflow_tpu.utils.pytree import unflatten as j_unflatten
from arcflow_tpu_torch.apis import train as t_train
from arcflow_tpu_torch.config import Config
from arcflow_tpu_torch.models import LatentDiffusionTextImage
from arcflow_tpu_torch.models import QwenImageTransformer2DModel as TTeacher
from arcflow_tpu_torch.models.layers import LoRADense
from arcflow_tpu_torch.pipelines import (jax_params_to_torch,
                                         load_jax_latent_diffusion)
from arcflow_tpu_torch.registry import MODELS
from test_torch_qwen_text import write_tokenizer
from test_torch_train import (GRAD_REL_L2, LOSS_RTOL, _jitter, _map,
                              _port_batch, _rel_l2, _replaying)

torch.set_num_threads(1)

U_TOL = dict(rtol=2e-4, atol=2e-5)
LOAD_TOL = dict(rtol=1e-6, atol=1e-6)
# tests/test_torch_qwen.py's tiny trunk, one block deep for the losses
# (the JAX loss runs eagerly)
NET = dict(in_channels=16, num_layers=1, attention_head_dim=32,
           num_attention_heads=2, joint_attention_dim=32,
           axes_dims_rope=(8, 12, 12), max_text_len=8, checkpointing=False)
# int4 in groups of 32: every trunk input width (32, 64, 256) splits,
# img_in's 16 does not; 1024 elements counted over the block stack
QUANT = dict(frozen_quant_min_size=1024, frozen_quant_group_size=32)
TRAIN_CFG = dict(nfe=2, timestep_ratio=1.0, total_substeps=128,
                 num_intermediate_states=2, window_substeps=3,
                 gm_dropout=0.1, num_decay_iters=100,
                 teacher_guidance_scale=4.0)
TRUNKS = {'bf16': {}, 'int8': dict(frozen_quant='int8', **QUANT),
          'int4': dict(frozen_quant='int4', **QUANT)}


def model_cfg(trunk='bf16', tie_teacher=True, cfg_scale=4.0, **over):
    """The tiny composition; ``over`` changes fields of the trunk (``NET``)
    or of the quantization (``QUANT``)."""
    net = {k: over.get(k, v) for k, v in NET.items()}
    quant = {k: over.get(k, v) for k, v in TRUNKS[trunk].items()}
    return dict(
        diffusion=dict(
            type='ArcFlowImitationDataFree', policy_type='ArcFlow',
            denoising=dict(type='ArcQwenImageTransformer2DModel',
                           patch_size=2, num_gaussians=4, lora_rank=4, **net),
            flow_loss=dict(type='DiffusionMSELoss',
                           data_info=dict(pred='u_t_pred', target='u_t'),
                           rescale_mode='constant',
                           rescale_cfg=dict(scale=30.0)),
            num_timesteps=1,
            timestep_sampler=dict(type='ContinuousTimeStepSampler',
                                  use_dynamic_shifting=True,
                                  base_seq_len=256, max_seq_len=4096,
                                  base_logshift=0.5, max_logshift=1.15),
            denoising_mean_mode='U'),
        teacher=dict(type='GaussianFlow',
                     denoising=dict(type='QwenImageTransformer2DModel',
                                    patch_size=2, **net),
                     num_timesteps=1, denoising_mean_mode='U'),
        tie_teacher=tie_teacher, latent_shape=(8, 8, 4),
        text_embed_dim=32, pooled_dim=32, max_text_len=8,
        frozen_dtype='bfloat16', **quant,
        train_cfg=dict(TRAIN_CFG, teacher_guidance_scale=cfg_scale),
        test_cfg=dict(nfe=2, timestep_ratio=1.0, total_substeps=128))


def jax_model(cfg):
    cfg = copy.deepcopy(cfg)
    for part in ('diffusion', 'teacher'):
        cfg[part]['denoising']['dtype'] = jnp.float32
    return JLatentDiffusion(**cfg)


def port_model(cfg, **kw):
    return LatentDiffusionTextImage(device='cpu', dtype=torch.float32,
                                    **copy.deepcopy(cfg), **kw)


def make_batch(bs=2, s_txt=8, seed=0, hw=8):
    """Row 0 has 5 of 8 text tokens, row 1 all; the negative embeds are
    zeros with one valid token; latents of ``hw`` x ``hw``."""
    rng = np.random.default_rng(seed)
    f = np.float32
    mask = np.ones((bs, s_txt), np.int64)
    mask[0, 5:] = 0
    neg_mask = np.zeros((bs, s_txt), np.int64)
    neg_mask[:, 0] = 1
    return dict(
        latents=rng.standard_normal((bs, hw, hw, 4)).astype(f),
        prompt_embed_kwargs=dict(
            encoder_hidden_states=rng.standard_normal((bs, s_txt, 32)
                                                      ).astype(f),
            encoder_hidden_states_mask=mask),
        negative_prompt_embed_kwargs=dict(
            encoder_hidden_states=np.zeros((bs, s_txt, 32), f),
            encoder_hidden_states_mask=neg_mask))


_INITS = {}


@contextlib.contextmanager
def jitted_inits():
    """JAX's Qwen denoisers' flax ``init`` under ``jax.jit``, for the JAX
    ``init_params`` that cannot be jitted whole (it reads checkpoint files):
    eager flax init of the tiny trunk costs seconds per module. One jitted
    init per module configuration, kept for the whole module."""
    def jitted(real):
        def init(self, rng, **kwargs):
            key = (type(self).__name__, repr(self))
            if key not in _INITS:
                _INITS[key] = jax.jit(lambda r, kw: real(self, r, **kw))
            return _INITS[key](rng, kwargs)
        return init
    with mock.patch.object(JArcQwen, 'init', jitted(JArcQwen.init)), \
            mock.patch.object(JTeacher, 'init', jitted(JTeacher.init)):
        yield


@functools.lru_cache(maxsize=None)
def _jax_pair_of(trunk, tie_teacher, seed=1):
    return _jax_pair(model_cfg(trunk, tie_teacher=tie_teacher), seed)


def _jax_pair(cfg, seed=1):
    """The JAX pair with every float leaf of the adapter and of the frozen
    trunk jittered (the trunk's rounded back to its bf16 storage), the
    int8 / int4 leaves and their scales as JAX made them."""
    trainable, frozen = jax.jit(jax_model(cfg).init_params)(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 6)

    def jitter(x):
        x = np.asarray(x)
        if x.dtype == np.int8:
            return x
        return (x.astype(np.float32) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)).astype(x.dtype)
    frozen = {k: (_map(jitter, jax.device_get(v)) if 'quant' not in k
                  else jax.device_get(v)) for k, v in frozen.items()}
    return _jitter(trainable, seed + 5), frozen


def _f32(tree):
    """bf16 leaves as fp32 (the same values), which torch can take."""
    return _map(lambda x: np.asarray(x).astype(np.float32)
                if np.asarray(x).dtype.name == 'bfloat16' else np.asarray(x),
                tree)


def _jitted_pred(flow):
    """``flow.pred`` with the flax ``apply`` under ``jax.jit`` (the JAX
    ``GaussianFlow.pred``, ``gaussian_flow.py:108-127``): the loss's own
    draws stay outside, eager, and the denoiser compiles once per shape."""
    apply = jax.jit(flow.denoising.apply)

    def pred(params, x_t, t, dropout_rng=None, **kwargs):
        assert dropout_rng is None and not flow.flip_model_timesteps
        t = jnp.asarray(t, jnp.float32)
        if t.ndim == 0:
            t = jnp.broadcast_to(t, (x_t.shape[0],))
        variables = params if isinstance(params, dict) and 'params' in params \
            else {'params': params}
        return apply(variables, x_t, t, **kwargs)
    return pred


def _jax_loss_and_grads(cfg, trainable, frozen, batch, iteration):
    """``test_torch_train.py``'s recording of the JAX loss, gradients and
    draws, with the denoisers' forwards jitted."""
    model = jax_model(cfg)
    jbatch = _map(jnp.asarray, batch)
    draws = []
    real = dict(uniform=jax.random.uniform, normal=jax.random.normal)

    def recording(kind):
        def fn(*args, **kwargs):
            out = real[kind](*args, **kwargs)
            if not isinstance(out, jax.core.Tracer):
                draws.append((kind, np.asarray(out)))
            return out
        return fn

    def loss_fn(tr):
        return model.loss(tr, frozen, jax.random.PRNGKey(2), jbatch,
                          running_status=dict(iteration=iteration))

    with mock.patch.object(jax.random, 'uniform', recording('uniform')), \
            mock.patch.object(jax.random, 'normal', recording('normal')), \
            mock.patch.object(model.diffusion, 'pred',
                              _jitted_pred(model.diffusion)), \
            mock.patch.object(model.teacher, 'pred',
                              _jitted_pred(model.teacher)):
        (loss, log_vars), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            _map(jnp.asarray, trainable))
    return float(loss), log_vars, jax.device_get(grads), draws


def _check_loss_and_grads(cfg, trainable, frozen, batch):
    j_loss, j_logs, j_grads, draws = _jax_loss_and_grads(
        cfg, trainable, frozen, batch, iteration=50)
    model = port_model(cfg)
    load_jax_latent_diffusion(model, trainable, _f32(frozen))
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
        if p.grad is None:
            # the last block's text stream reaches no output: JAX's
            # gradient there is zero, autograd's is None
            assert name.startswith(f'transformer_blocks.{NET["num_layers"] - 1}'
                                   '.ff_txt.'), name
            assert not want[name].numpy().any(), name
            continue
        err = _rel_l2(p.grad.numpy(), want[name].numpy())
        assert err <= GRAD_REL_L2, (name, err)
    return model


def test_teacher_u_matches_jax():
    rng = np.random.default_rng(3)
    mask = np.ones((2, 8), np.int32)
    mask[0, 4:] = 0
    inp = dict(hidden_states=rng.standard_normal((2, 8, 8, 4)).astype(
        np.float32), t=np.array([0.25, 0.9], np.float32),
        encoder_hidden_states=rng.standard_normal((2, 8, 32)).astype(
            np.float32), encoder_hidden_states_mask=mask)
    jm = JTeacher(patch_size=2, dtype=jnp.float32, **dict(NET, num_layers=2))
    params = _jitter(jax.jit(jm.init)(
        jax.random.PRNGKey(0), **{k: jnp.asarray(v) for k, v in inp.items()}
    )['params'], 4)
    want = np.asarray(jax.jit(jm.apply)(
        {'params': params}, **{k: jnp.asarray(v) for k, v in inp.items()}))
    tm = TTeacher(dtype=torch.float32, **dict(NET, num_layers=2))
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(**{k: torch.from_numpy(v) for k, v in inp.items()})
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), want, **U_TOL)


@pytest.mark.parametrize('trunk, tie_teacher', [
    ('bf16', True), ('int8', True), ('int4', False)],
    ids=['bf16', 'int8', 'int4_untied'])
def test_loss_and_adapter_grads_match_jax(trunk, tie_teacher):
    """Key-padded text, CFG at scale 4 (a teacher batch of 2B, negative
    embeds first), the frozen trunk in bf16, int8 or int4. The int4 case
    has ``tie_teacher=False``: the teacher is whole and its own
    (``teacher_full`` with its own ``teacher_quant``), quantized apart from
    the student's trunk. The latents are 6 x 6, another resolution bucket
    than ``latent_shape``'s 8 x 8, as JAX trains every bucket."""
    cfg = model_cfg(trunk, tie_teacher=tie_teacher)
    trainable, frozen = _jax_pair_of(trunk, tie_teacher)
    if trunk != 'bf16':
        assert 'base_quant' in frozen
    if not tie_teacher:
        assert {'teacher_full', 'teacher_quant'} <= set(frozen)
    model = _check_loss_and_grads(cfg, trainable, frozen, make_batch(hw=6))
    n_quant = sum(isinstance(m, LoRADense) and m.is_quantized
                  for m in model.diffusion.denoising.modules())
    assert n_quant == (0 if trunk == 'bf16' else 14 + 3 + (
        trunk == 'int8'))                    # int8 also takes img_in
    t_frozen = model.init_params()[1]
    assert ('teacher_full' in t_frozen) != tie_teacher
    if not tie_teacher:
        student = model.diffusion.denoising.state_dict(keep_vars=True)
        for name, t in t_frozen['teacher_full'].items():
            assert name not in student or \
                t.data_ptr() != student[name].data_ptr(), name


@pytest.mark.parametrize('trunk', ['bf16', 'int8'])
def test_untied_teacher_keeps_a_trunk_of_its_own(trunk):
    """``tie_teacher=False`` builds the teacher whole (JAX's
    ``frozen['teacher_full']``), on storage of its own."""
    _, frozen = port_model(model_cfg(trunk, tie_teacher=False)).init_params()
    assert set(frozen) == {'base', 'teacher_full'}
    ptrs = {t.data_ptr() for t in frozen['base'].values()}
    assert not any(t.data_ptr() in ptrs
                   for t in frozen['teacher_full'].values())
    kernels = [n for n in frozen['teacher_full'] if n.endswith('.kernel')]
    assert bool(kernels) == (trunk == 'int8')


@pytest.mark.parametrize('trunk', ['bf16', 'int8', 'int4'])
def test_tied_teacher_shares_the_student_trunk_storage(trunk):
    """The tied teacher's trunk tensors, the quantized buffers included,
    are the student's own: the trunk is in memory once."""
    model = port_model(model_cfg(trunk))
    student = model.diffusion.denoising
    teacher = model.teacher.denoising
    s_state = student.state_dict(keep_vars=True)
    t_state = teacher.state_dict(keep_vars=True)
    head = {n for n in t_state if n.startswith(('proj_out.', 'norm_out.'))}
    assert head == {'proj_out.weight', 'proj_out.bias',
                    'norm_out.modulation.weight', 'norm_out.modulation.bias'}
    shared = [n for n in t_state if n not in head]
    assert shared and not any('lora' in n for n in t_state)
    for n in shared:
        assert t_state[n] is s_state[n], n
        assert t_state[n].data_ptr() == s_state[n].data_ptr(), n
    kernels = [n for n in shared if n.endswith(('.kernel', '.kernel_packed4'))]
    assert bool(kernels) == (trunk != 'bf16')
    assert not any(t.device.type == 'meta' for t in t_state.values())
    _, frozen = model.init_params()
    assert set(frozen) == {'base', 'teacher_head'}
    assert set(frozen['teacher_head']) == head
    ptrs = {t.data_ptr() for t in frozen['base'].values()}
    assert all(t_state[n].data_ptr() in ptrs for n in shared)


def test_quantized_split_matches_jax():
    """The frozen base of an int8 and an int4 trunk holds the layers JAX
    quantizes (its ``base`` + ``base_quant``), with their dtypes. Two
    blocks at a minimum size of 6000: a block's 64 x 64 projections (4096)
    quantize only as a stack, as JAX counts its scanned stacks. JAX's
    split is read from the shapes of its ``init_params`` (``eval_shape``)."""
    def zeros(x):
        return np.zeros(x.shape, x.dtype)
    for trunk in ('int8', 'int4'):
        cfg = model_cfg(trunk, num_layers=2, frozen_quant_min_size=6000)
        frozen = jax.eval_shape(jax_model(cfg).init_params,
                                jax.random.PRNGKey(1))[1]
        want = jax_params_to_torch(_f32(_map(zeros, frozen['base'])),
                                   _map(zeros, frozen['base_quant']))
        got = port_model(cfg).init_params()[1]['base']
        assert set(got) == set(want), trunk
        for k, v in got.items():
            assert tuple(v.shape) == tuple(want[k].shape), k
            if want[k].dtype == torch.int8 or k.endswith(('.kernel_scale',
                                                          '.kernel_scale4')):
                assert v.dtype == want[k].dtype, k
            else:
                assert v.dtype == torch.bfloat16, k
        assert 'transformer_blocks.1.attn.img_q.weight' not in got


def _meta_model(path, **over):
    cfg = Config.fromfile(path)
    cfg.merge_from_dict({'parallel.mesh': {k: 1 for k in
                                           cfg.parallel.mesh}})
    return cfg, MODELS.build(cfg.model, default_args=dict(
        train_cfg=cfg.get('train_cfg'), test_cfg=cfg.get('test_cfg'),
        device='meta', **over))


@pytest.mark.parametrize('name', ['arcqwen_2nfe_k16',
                                  'arcqwen_2nfe_k16_int8trunk'])
def test_shipped_qwen_configs_build_at_full_width(name):
    """Both Qwen configs build through the port's ``Config`` and ``MODELS``
    with every mesh axis set to 1 and nothing else changed, at full width,
    on the meta device: 60 blocks, LoRA rank 256 on the four MLP
    projections and the timestep embedder of each, 0.95 B adapter
    parameters; the int8 config quantizes every trunk kernel (14 per block,
    img_in, txt_in and the two timestep-embedder linears)."""
    cfg, model = _meta_model(f'configs/qwen/{name}.py')
    student = model.diffusion.denoising
    assert len(student.transformer_blocks) == 60
    assert student.lora_dropout == 0.05 and student.checkpointing
    trainable, frozen = model.init_params()
    n_adapter = sum(t.numel() for t in trainable['diffusion'].values())
    # per block 4 MLP LoRAs x 256 x (3072 + 12288), plus the timestep
    # embedder's (256 + 3072) + (3072 + 3072), the three heads and norm_out
    lora = 60 * 4 * 256 * 15360 + 256 * (256 + 3072 + 3072 + 3072)
    heads = 3072 * (1024 + 64 + 60) + 1024 + 64 + 60
    norm_out = 3072 * 6144 + 6144
    assert n_adapter == lora + heads + norm_out == 968_551_548
    quantized = [m for m in student.modules()
                 if isinstance(m, LoRADense) and m.is_int8]
    if name.endswith('int8trunk'):
        assert len(quantized) == 14 * 60 + 4
        assert all(not m.act_quant for m in quantized)
        assert all(t.dtype in (torch.int8, torch.float32, torch.bfloat16)
                   for t in frozen['base'].values())
    else:
        assert not quantized
    assert 'teacher_head' in frozen


def test_qwen_train_cfg_lacks_the_unmerged_train_cfg_base():
    """``configs/flux/_mesh_train.py:23-27`` defines ``train_cfg_base`` with
    ``diffusion_grad_clip_skip_ratio=20.0``, but no config merges it into
    ``train_cfg``: the Qwen config's ``train_cfg`` (the one the trainer
    reads) has no skip ratio, so only non-finite gradients are skipped, in
    both packages."""
    cfg = Config.fromfile('configs/qwen/arcqwen_2nfe_k16_int8trunk.py')
    assert cfg.train_cfg_base['diffusion_grad_clip_skip_ratio'] == 20.0
    assert 'diffusion_grad_clip_skip_ratio' not in cfg.train_cfg
    assert cfg.train_cfg['diffusion_grad_clip'] == 50.0


def test_val_step_matches_jax():
    """Samples with the EMA adapter, from the batch's noise, decoded by a
    tiny Wan VAE and clipped, against JAX's ``val_step``."""
    from arcflow_tpu.models.qwen_vae import PretrainedVAEQwenImage as JVAE
    cfg = model_cfg('int8')
    vae_cfg = dict(base_dim=32, z_dim=4, dim_mult=(1, 2, 2, 2),
                   num_res_blocks=1)
    trainable, frozen = _jax_pair_of('int8', True)
    ema = _jitter(trainable, 11)
    jm = jax_model(cfg)
    jvae = JVAE(dtype='float32', **vae_cfg)
    jm.vae = jvae
    k_dec, k_pqc = jax.random.split(jax.random.PRNGKey(3))
    vparams = _jitter(dict(           # the decoding half, initialised jitted
        decoder=jax.jit(jvae.decoder.init)(
            k_dec, jnp.zeros((1, 8, 8, 4)))['params'],
        post_quant_conv=jax.jit(jvae.post_quant_conv.init)(
            k_pqc, jnp.zeros((1, 1, 1, 4)))['params']), 12)
    batch = make_batch()
    noise = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    state = JTrainState.create(jax.random.PRNGKey(0), trainable,
                               dict(frozen, vae=vparams), {},
                               ema_keys=('diffusion',))
    state = state.replace(ema=ema)
    jbatch = dict(_map(jnp.asarray, batch), noise=jnp.asarray(noise))
    want = jax.jit(lambda st, b: jm.val_step(st, jax.random.PRNGKey(1), b,
                                             use_ema=True))(state, jbatch)

    model = port_model(dict(cfg, vae=dict(type='PretrainedVAEQwenImage',
                                          dtype='float32', **vae_cfg)))
    load_jax_latent_diffusion(model, trainable, _f32(frozen))
    model.vae.load_state_dict(jax_params_to_torch(vparams), strict=True)
    ema_t = jax_params_to_torch(ema['diffusion'])
    got = model.val_step(dict(_port_batch(batch),
                              noise=torch.from_numpy(noise)),
                         torch.Generator(), ema=ema_t)
    assert got['num_samples'] == 2
    img = got['pred_imgs'].numpy()
    assert img.shape == (2, 64, 64, 3) and img.min() >= 0 and img.max() <= 1
    np.testing.assert_allclose(img, np.asarray(want['pred_imgs']),
                               rtol=1e-3, atol=1e-4)
    # the live adapter is back after sampling with the EMA
    live = model.init_params()[0]['diffusion']
    want_live = jax_params_to_torch(trainable['diffusion'])
    for k, v in live.items():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      want_live[k].numpy())


# ---- train_model ------------------------------------------------------------

SIZES = (64, 48)          # pixels square of each bucket


@pytest.fixture(scope='module')
def text_dir(tmp_path_factory):
    """A Qwen2.5-VL checkpoint folder holding a 2-layer decoder of width 32
    (4 heads over 2 KV heads), random weights from a seed, and a tiny BPE
    tokenizer: what the native text encoder reads."""
    from safetensors.torch import save_file
    from arcflow_tpu_torch.models.qwen_text import Qwen25TextModel
    d = tmp_path_factory.mktemp('qwen_text')
    text = dict(vocab_size=240, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                intermediate_size=64, rope_theta=1e6, rms_norm_eps=1e-6)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = Qwen25TextModel(
            vocab_size=240, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, dtype=torch.float32)
        with torch.no_grad():       # visible norm scales
            for name, p in model.named_parameters():
                p.copy_(0.1 * torch.randn_like(p) + (p.dim() == 1))
    save_file({'model.language_model.' + k: v.contiguous()
               for k, v in model.state_dict().items()},
              str(d / 'model.safetensors'))
    (d / 'config.json').write_text(json.dumps(dict(
        architectures=['Qwen2_5_VLForConditionalGeneration'],
        text_config=text)))
    write_tokenizer(str(d))
    (d / 'tokenizer_config.json').write_text(json.dumps(dict(
        tokenizer_class='Qwen2Tokenizer', unk_token='<unk>',
        eos_token='<|im_end|>', pad_token='<pad>')))
    return str(d)


def write_config(tmp_path, text_dir, buckets):
    """Four prompts over ``buckets`` resolution buckets: with a batch of 2,
    one epoch is two batches, one of each bucket when there are two."""
    prompts = tmp_path / 'prompts.jsonl'
    with open(prompts, 'w') as f:
        for i in range(4):
            hw = SIZES[i % buckets]
            f.write(json.dumps({'prompt': f'a photo of a cat number {i}',
                                'size_idx': i % buckets,
                                'height': hw, 'width': hw}) + '\n')
    cfg = model_cfg('int8')
    cfg['text_encoder'] = dict(type='PretrainedQwenImageTextEncoder',
                               pretrained=text_dir, pad_seq_len=8,
                               dtype='float32')
    cfg.update(type='LatentDiffusionTextImage', dtype='float32')
    train_cfg = cfg.pop('train_cfg')
    test_cfg = cfg.pop('test_cfg')
    path = tmp_path / 'qwen_tiny.py'
    path.write_text(textwrap.dedent(f'''\
        name = 'qwen_tiny'
        model = {cfg!r}
        train_cfg = {train_cfg!r}
        test_cfg = {test_cfg!r}
        optimizer = dict(diffusion=dict(type='AdamW', lr=1e-3,
                                        betas=(0.9, 0.95), weight_decay=0.0))
        data = dict(train=dict(type='ImagePrompt',
                               prompts_path={str(prompts)!r},
                               latent_size=(8, 8, 4),
                               negative_prompt='blurry'),
                    train_dataloader=dict(samples_per_gpu=2))
        checkpoint_config = dict(interval=1000)
        log_config = dict(interval=1, hooks=[dict(type='JsonLoggerHook')])
        total_iters = 2
        '''))
    return str(path)


@pytest.mark.parametrize('buckets', [2, 1], ids=['bucketized', 'plain'])
def test_train_model_runs_qwen_from_prompts(tmp_path, text_dir, buckets):
    path = write_config(tmp_path, text_dir, buckets)
    spies = {name: mock.Mock(wraps=getattr(t_train, name))
             for name in ('build_bucketized_loader', 'build_dataloader',
                          'build_train_step')}
    seen = []
    real_latents = LatentDiffusionTextImage._latents

    def latents(self, batch):
        out = real_latents(self, batch)
        seen.append(tuple(out.shape))
        return out
    with mock.patch.multiple(t_train, **spies), \
            mock.patch.object(LatentDiffusionTextImage, '_latents', latents):
        state, model = t_train.train_model(
            Config.fromfile(path), work_dir=str(tmp_path / 'work'),
            device='cpu')
    assert state.step == 2
    assert spies['build_bucketized_loader'].called == (buckets > 1)
    assert spies['build_dataloader'].called == (buckets == 1)
    # JAX's sampler for train_model's seed (0): the bucket of each batch
    order = [int(b[0]) % buckets
             for b in JSampler([i % buckets for i in range(4)], 2,
                               seed=0).epoch_batches(0)]
    want = [(2, SIZES[b] // 8, SIZES[b] // 8, 4) for b in order]
    assert seen == want and (buckets == 1 or len(set(seen)) == 2)
    ema_cfg = spies['build_train_step'].call_args.kwargs['ema_cfg']
    assert (ema_cfg.momentum_policy, ema_cfg.momentum) == ('fixed', 0.999)
    with open(tmp_path / 'work' / 'metrics.jsonl') as f:
        logs = [json.loads(line) for line in f]
    assert [r['iter'] for r in logs] == [1, 2]
    assert all(np.isfinite(r['loss']) and np.isfinite(
        r['diffusion_grad_norm']) for r in logs)
    assert model.text_encoder is not None


# ---- pretrained ----------------------------------------------------------------

def _teacher_params(seed=0):
    jm = JTeacher(patch_size=2, dtype=jnp.float32, **NET)
    with jitted_inits():       # the composition's dummy inputs: one init
        params = jm.init(jax.random.PRNGKey(seed),
                         hidden_states=jnp.zeros((1, 8, 8, 4)),
                         t=jnp.zeros((1,)),
                         encoder_hidden_states=jnp.zeros((1, 8, 32)),
                         pooled_projections=jnp.zeros((1, 32)))['params']
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
        np.shape(x)).astype(np.float32), jax.device_get(params))


def _write_checkpoint(path, params):
    from safetensors.numpy import save_file
    state = flax_to_torch_flux(params, family='qwen')
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()}, path)


def _write_lora(path, seed, scale=0.02):
    """An adapter file of LoRA leaves on every block's MLP projections."""
    rng = np.random.default_rng(seed)
    tree = {}
    for layer in ('ff_img.in_proj', 'ff_img.out_proj', 'ff_txt.in_proj'):
        i, o = (64, 256) if layer.endswith('in_proj') else (256, 64)
        tree[f'transformer_blocks.{layer}.lora_a'] = scale * \
            rng.standard_normal((NET['num_layers'], i, 4)).astype(np.float32)
        tree[f'transformer_blocks.{layer}.lora_b'] = scale * \
            rng.standard_normal((NET['num_layers'], 4, o)).astype(np.float32)
    j_save_adapter(path, j_unflatten(tree), family='qwen')


def _pretrained_cfg(ckpt, adapter=None, lora=None, tie_teacher=True):
    cfg = model_cfg('bf16', tie_teacher=tie_teacher)
    cfg.pop('frozen_dtype')
    cfg['diffusion']['denoising'].update(pretrained=ckpt,
                                         pretrained_adapter=adapter)
    if lora:
        cfg['teacher']['denoising'].update(pretrained_lora=lora,
                                           pretrained_lora_scale=0.5)
    return cfg


def _assert_tree_close(got, want, what):
    want = jax_params_to_torch(jax.device_get(want))
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().float().numpy(),
                                   want[k].numpy(), err_msg=f'{what} {k}',
                                   **LOAD_TOL)


@pytest.mark.parametrize('variant', ['adapter_and_teacher_lora',
                                     'untied_teacher_lora'])
def test_pretrained_loads_as_jax(tmp_path, variant):
    params = _teacher_params()
    ckpt = str(tmp_path / 'teacher.safetensors')
    _write_checkpoint(ckpt, params)
    adapter = None
    lora = str(tmp_path / 'teacher_lora.safetensors')
    _write_lora(lora, 2)
    if variant == 'adapter_and_teacher_lora':
        adapter = str(tmp_path / 'adapter.safetensors')
        _write_lora(adapter, 3)
    tie = variant != 'untied_teacher_lora'
    cfg = _pretrained_cfg(ckpt, adapter, lora, tie_teacher=tie)
    with jitted_inits():
        j_trainable, j_frozen = jax_model(cfg).init_params(
            jax.random.PRNGKey(1))
    model = port_model(cfg)
    trainable, frozen = model.init_params()
    _assert_tree_close(frozen['base'], j_frozen['base'], 'base')
    if tie:
        _assert_tree_close(frozen['teacher_head'], j_frozen['teacher_head'],
                           'teacher head')
    else:
        # JAX fuses an untied teacher's LoRA only when it loads a file of its
        # own (``t_converted is not converted``); on the student's file it
        # drops them. The port fuses them in both cases.
        from arcflow_tpu.pipelines.convert import fuse_pretrained_loras
        want = jax.tree.map(np.asarray, fuse_pretrained_loras(
            jax.device_get(j_frozen['teacher_full']), lora, 0.5,
            family='qwen'))
        _assert_tree_close(frozen['teacher_full'], want, 'teacher')
    # the means head: the teacher's proj_out tiled K times; its bias plus
    # 0.05 x noise shared over the p*p cells
    adapter_t = {k: v for k, v in trainable['diffusion'].items()
                 if not k.startswith('proj_out_means.')}
    want_adapter = {k: v for k, v in j_flatten(jax.device_get(
        j_trainable['diffusion'])).items()
        if not k.startswith(('proj_out_means.',))
        and 'lora' not in k}
    _assert_tree_close({k: v for k, v in adapter_t.items() if 'lora' not in k},
                       j_unflatten(want_adapter), 'adapter heads')
    w = trainable['diffusion']['proj_out_means.weight'].detach().numpy()
    t_w = np.asarray(params['proj_out']['kernel']).T           # (out, in)
    np.testing.assert_allclose(w.reshape(4, *t_w.shape),
                               np.broadcast_to(t_w, (4, *t_w.shape)),
                               **LOAD_TOL)
    b = trainable['diffusion']['proj_out_means.bias'].detach().numpy()
    noise = (b.reshape(4, 4, 4) - np.asarray(params['proj_out']['bias'])
             .reshape(1, 4, 4)) / 0.05                        # (K, p*p, C)
    np.testing.assert_allclose(noise, np.broadcast_to(noise[:, :1],
                                                      noise.shape), atol=1e-4)
    assert np.abs(noise).max() < 6 and np.abs(noise).max() > 1e-3
