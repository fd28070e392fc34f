"""Loading and serving from diffusers folders in the port
(``ArcFluxPipeline.from_pretrained``, ``_from_pipeline_folder``,
``load_arcflow_adapter``, ``encode_prompt`` and ``__call__(prompt=...)``,
the inference CLIs) against the JAX package on the same folders.

Folders are written here: tiny ArcFlux (2 + 2 blocks) and ArcQwen (2
blocks) with jittered JAX params in diffusers naming, K = 4 heads, LoRA
rank 2; synthetic diffusers VAEs (``test_vae_convert.py``); the CLIP, T5
and Qwen2.5-VL towers and tokenizers of ``test_torch_text_encoders.py``.
JAX builds its transformer in fp32 (a ``partial`` of the class) and its
VAE from the same folder in fp32 (its ``_load_vae_folder`` fixes bf16).
Both sides get the same latents from numpy. Tolerances are
``tests/test_torch_pipeline.py``'s: latents rtol=2e-4, atol=5e-5; images
atol=1e-4.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
from arcflow_tpu.models import PretrainedVAE as JVAE
from arcflow_tpu.models import PretrainedVAEQwenImage as JQwenVAE
from arcflow_tpu.pipelines import ArcFluxPipeline as JFluxPipe
from arcflow_tpu.pipelines import ArcQwenImagePipeline as JQwenPipe
from arcflow_tpu.pipelines.convert import flax_to_torch_flux
from arcflow_tpu_torch.models import ArcFluxTransformer2DModel
from arcflow_tpu_torch.models.flux import ARCFLUX_ADAPTER_KEYS
from arcflow_tpu_torch.pipelines import (ArcFluxPipeline,
                                         ArcQwenImagePipeline, fuse_lora,
                                         jax_params_to_torch,
                                         save_adapter_state)
from arcflow_tpu_torch.utils.pytree import name_matches
from test_torch_qwen_text import PROMPTS, qwen_dir  # noqa: F401
from test_torch_text_encoders import clip_dir, t5_dir  # noqa: F401
from test_vae_convert import (synth_autoencoder_kl_state,
                              synth_qwen_vae_state)

torch.set_num_threads(1)
CPU = dict(device='cpu', dtype=torch.float32)
FLUX = dict(in_channels=16, num_layers=2, num_single_layers=2,
            attention_head_dim=16, num_attention_heads=2,
            joint_attention_dim=80, pooled_projection_dim=32,
            axes_dims_rope=[4, 6, 6], guidance_embeds=True, patch_size=2,
            num_gaussians=4, lora_rank=2, checkpointing=False)
QWEN = dict(in_channels=16, num_layers=2, attention_head_dim=16,
            num_attention_heads=2, joint_attention_dim=32,
            axes_dims_rope=[4, 6, 6], patch_size=2, num_gaussians=4,
            lora_rank=2, checkpointing=False)
FLUX_VAE = dict(latent_channels=4, block_out_channels=[32, 64],
                layers_per_block=1, scaling_factor=0.5, shift_factor=0.1)
QWEN_VAE = dict(base_dim=32, z_dim=4, dim_mult=[1, 2], num_res_blocks=1,
                latents_mean=[0.1, -0.2, 0.0, 0.3],
                latents_std=[1.5, 0.5, 1.0, 2.0])
PIPE = dict(nfe=2, temperature=0.7)
LAT_TOL = dict(rtol=2e-4, atol=5e-5)


def _jax_params(cls, cfg, seed, **inputs):
    model = cls(dtype=jnp.float32, **{k: tuple(v) if isinstance(v, list)
                                      else v for k, v in cfg.items()})
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), **inputs)['params']
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
        np.shape(x)).astype(np.float32), jax.device_get(params))


@pytest.fixture(scope='module')
def params():
    z = jnp.zeros
    flux = _jax_params(JArcFlux, FLUX, 1, hidden_states=z((1, 8, 8, 4)),
                       t=z((1,)), encoder_hidden_states=z((1, 5, 80)),
                       pooled_projections=z((1, 32)), guidance=z((1,)))
    qwen = _jax_params(JArcQwen, QWEN, 2, hidden_states=z((1, 8, 8, 4)),
                       t=z((1,)), encoder_hidden_states=z((1, 5, 32)),
                       encoder_hidden_states_mask=jnp.ones((1, 5), jnp.int32))
    return dict(flux=flux, qwen=qwen)


def _write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f)


def write_transformer(d, family, params, cfg=None):
    from safetensors.numpy import save_file
    name = 'ArcFluxTransformer2DModel' if family == 'flux' \
        else 'ArcQwenImageTransformer2DModel'
    cfg = dict(cfg or (FLUX if family == 'flux' else QWEN),
               _class_name=name, _diffusers_version='0.35.0')
    _write_json(os.path.join(d, 'config.json'), cfg)
    state = flax_to_torch_flux(params, family=family)
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()},
              os.path.join(d, 'diffusion_pytorch_model.safetensors'))
    return d


def write_vae(d, family):
    from safetensors.numpy import save_file
    if family == 'flux':
        state = synth_autoencoder_kl_state(block_out=(32, 64), layers=1,
                                           z=4, quant=False, seed=3)
        cfg = dict(FLUX_VAE, _class_name='AutoencoderKL')
    else:
        state = synth_qwen_vae_state(base=32, mult=(1, 2), nres=1, z=4,
                                     seed=4)
        cfg = dict(QWEN_VAE, _class_name='AutoencoderKLQwenImage')
    _write_json(os.path.join(d, 'config.json'), cfg)
    save_file(state, os.path.join(d, 'diffusion_pytorch_model.safetensors'))
    return d


def jax_vae(d, family):
    """JAX's VAE of a folder, in fp32, with its params."""
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in (FLUX_VAE if family == 'flux' else QWEN_VAE).items()}
    vae = (JVAE if family == 'flux' else JQwenVAE)(
        from_pretrained=d, dtype='float32', **cfg)
    return dict(vae=vae, vae_params=vae.init_params(jax.random.PRNGKey(0)))


# FLUX.1-dev's scheduler_config.json, on whose dynamic-shift fields the
# port and JAX agree
SCHEDULER = dict(_class_name='FlowMatchEulerDiscreteScheduler', shift=3.0,
                 use_dynamic_shifting=True, base_shift=0.5, max_shift=1.15,
                 base_image_seq_len=256, max_image_seq_len=4096)


@pytest.fixture(scope='module')
def folders(tmp_path_factory, params, clip_dir, t5_dir,  # noqa: F811
            qwen_dir):  # noqa: F811
    root = str(tmp_path_factory.mktemp('folders'))
    out = {}
    for family in ('flux', 'qwen'):
        out[family] = write_transformer(os.path.join(root, family), family,
                                        params[family])
        out[family + '_vae'] = write_vae(os.path.join(root, family + '_vae'),
                                         family)
        pipe = os.path.join(root, family + '_pipe')
        write_transformer(os.path.join(pipe, 'transformer'), family,
                          params[family])
        write_vae(os.path.join(pipe, 'vae'), family)
        _write_json(os.path.join(pipe, 'scheduler', 'scheduler_config.json'),
                    SCHEDULER)
        index = dict(_class_name='ArcFluxPipeline',
                     transformer=['diffusers', 'ArcFluxTransformer2DModel'],
                     scheduler=['diffusers',
                                'FlowMatchEulerDiscreteScheduler'])
        if family == 'flux':
            index.update(vae=['diffusers', 'AutoencoderKL'],
                         text_encoder=['transformers', 'CLIPTextModel'],
                         text_encoder_2=['transformers', 'T5EncoderModel'],
                         tokenizer=['transformers', 'CLIPTokenizer'],
                         tokenizer_2=['transformers', 'T5TokenizerFast'])
            for sub, src in (('text_encoder', clip_dir),
                             ('tokenizer', clip_dir),
                             ('text_encoder_2', t5_dir),
                             ('tokenizer_2', t5_dir)):
                shutil.copytree(src, os.path.join(pipe, sub))
        else:
            index.update(vae=['diffusers', 'AutoencoderKLQwenImage'],
                         text_encoder=['transformers',
                                       'Qwen2_5_VLForConditionalGeneration'],
                         tokenizer=['transformers', 'Qwen2Tokenizer'])
            for sub in ('text_encoder', 'tokenizer'):
                shutil.copytree(qwen_dir, os.path.join(pipe, sub))
        _write_json(os.path.join(pipe, 'model_index.json'), index)
        out[family + '_pipe'] = pipe
    return out


def noise(shape=(1, 8, 8, 4), seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def embeds(family, seed=6):
    rng = np.random.default_rng(seed)
    f = np.float32
    if family == 'flux':
        return dict(encoder_hidden_states=rng.standard_normal((1, 6, 80)
                                                              ).astype(f),
                    pooled_projections=rng.standard_normal((1, 32)).astype(f))
    mask = np.ones((1, 6), np.int32)
    mask[:, 4:] = 0
    return dict(encoder_hidden_states=rng.standard_normal((1, 6, 32)
                                                          ).astype(f),
                encoder_hidden_states_mask=mask)


def adapter(params, family, shift=0.1):
    keys = ARCFLUX_ADAPTER_KEYS
    return {k: v + shift for k, v in jax_params_to_torch(params).items()
            if name_matches(k, keys)}


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_transformer_folder_with_adapter_matches_jax(folders, params, family,
                                                     tmp_path):
    """Transformer folder + a VAE folder + an adapter file: the port's
    weights are the folder's bitwise, and its latents and image are JAX's
    within tolerance."""
    p = params[family]
    j_cls = JFluxPipe if family == 'flux' else JQwenPipe
    t_cls = ArcFluxPipeline if family == 'flux' else ArcQwenImagePipeline
    j_model = JArcFlux if family == 'flux' else JArcQwen
    path = str(tmp_path / 'adapter.safetensors')
    save_adapter_state(path, adapter(p, family),
                       policy_config=dict(nfe=2, timestep_ratio=0.8),
                       family=family)

    tp = t_cls.from_pretrained(folders[family], **CPU, **PIPE,
                               vae=t_cls._load_vae_folder(
                                   folders[family + '_vae'],
                                   'AutoencoderKLQwenImage'
                                   if family == 'qwen' else '', **CPU))
    got = tp.transformer.state_dict()
    for k, v in jax_params_to_torch(p).items():
        assert torch.equal(got[k], v), k
    assert tp.load_arcflow_adapter(path)['timestep_ratio'] == 0.8
    assert tp.diffusion.test_cfg['timestep_ratio'] == 0.8
    got = tp.transformer.state_dict()
    for k, v in adapter(p, family).items():
        assert torch.equal(got[k], v), k

    jp = j_cls.from_pretrained(
        folders[family], transformer_cls=functools.partial(
            j_model, dtype=jnp.float32), **PIPE,
        **jax_vae(folders[family + '_vae'], family))
    jp.load_arcflow_adapter(path)
    e, x = embeds(family), noise()
    j_lat = np.asarray(jp(prompt_embeds={k: jnp.asarray(v) for k, v in
                                         e.items()},
                          latents=jnp.asarray(x), output_type='latent'
                          )['latents'])
    j_img = np.asarray(jp(prompt_embeds={k: jnp.asarray(v) for k, v in
                                         e.items()},
                          latents=jnp.asarray(x))['images'])
    te = {k: torch.from_numpy(v) for k, v in e.items()}
    t_lat = tp(prompt_embeds=te, latents=torch.from_numpy(x),
               output_type='latent')['latents'].numpy()
    t_img = tp(prompt_embeds=te, latents=torch.from_numpy(x))['images']
    assert np.abs(t_lat - x).max() > 0.1
    np.testing.assert_allclose(t_lat, j_lat, **LAT_TOL)
    assert t_img.shape == j_img.shape
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=1e-4)


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_pipeline_folder_from_a_prompt_matches_jax(folders, family):
    """A whole pipeline folder: text towers, VAE, scheduler and
    transformer in one call on both sides; the image from a prompt, and
    from ``encode_prompt``'s embeds (bitwise the same)."""
    t_cls = ArcFluxPipeline if family == 'flux' else ArcQwenImagePipeline
    j_cls = JFluxPipe if family == 'flux' else JQwenPipe
    j_model = JArcFlux if family == 'flux' else JArcQwen
    te_kw = dict(max_sequence_length=16) if family == 'flux' \
        else dict(pad_seq_len=128)
    root = folders[family + '_pipe']
    tp = t_cls.from_pretrained(root, **CPU, **PIPE,
                               text_encoder_kwargs=te_kw)
    jp = j_cls.from_pretrained(
        root, transformer_cls=functools.partial(j_model, dtype=jnp.float32),
        text_encoder_kwargs=dict(te_kw, dtype='float32'), **PIPE,
        **jax_vae(os.path.join(root, 'vae'), family))
    x = noise()
    t_img = tp(prompt=PROMPTS[:1], latents=torch.from_numpy(x))['images']
    j_img = np.asarray(jp(prompt=PROMPTS[:1], latents=jnp.asarray(x)
                          )['images'])
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=1e-4)
    again = tp(prompt_embeds=tp.encode_prompt(PROMPTS[0]),
               latents=torch.from_numpy(x))['images']
    np.testing.assert_array_equal(again, t_img)


def test_scheduler_fields_all_read_unlike_jax(folders, tmp_path):
    """The port reads every field of ``scheduler_config.json`` and keeps
    the folder's ``use_dynamic_shifting`` when ``shift=`` is passed. JAX
    (``arcflow_tpu/pipelines/arcflux_pipeline.py:224-233``) drops
    base_shift / max_shift / base_image_seq_len / max_image_seq_len and
    reads neither field when ``shift=`` is passed: the two agree only on
    FLUX.1-dev's values (0.5 / 1.15 / 256 / 4096). Explicit keyword
    arguments beat the folder's, field by field."""
    root = str(tmp_path / 'pipe')
    shutil.copytree(folders['flux_pipe'], root)
    _write_json(os.path.join(root, 'scheduler', 'scheduler_config.json'),
                dict(SCHEDULER, shift=2.5, base_shift=0.3, max_shift=0.9,
                     base_image_seq_len=8, max_image_seq_len=64))
    sampler = ArcFluxPipeline._from_pipeline_folder(
        root, **CPU, text_encoder=None).diffusion.timestep_sampler
    assert (sampler.shift, sampler.use_dynamic_shifting) == (2.5, True)
    assert (sampler.base_logshift, sampler.max_logshift,
            sampler.base_seq_len, sampler.max_seq_len) == (0.3, 0.9, 8, 64)
    sampler = ArcFluxPipeline.from_pretrained(
        root, shift=3.0, max_shift=1.2, **CPU,
        text_encoder=None).diffusion.timestep_sampler
    assert (sampler.shift, sampler.use_dynamic_shifting,
            sampler.base_logshift, sampler.max_logshift) == (3.0, True, 0.3,
                                                             1.2)
    # the reference's reading of the same folder
    j = JFluxPipe.from_pretrained(
        root, text_encoder=None, vae=None,
        transformer_cls=functools.partial(JArcFlux, dtype=jnp.float32))
    jd = j.diffusion.timestep_sampler
    assert (jd.shift, jd.use_dynamic_shifting) == (2.5, True)
    assert (jd.base_logshift, jd.max_logshift) == (0.5, 1.15)
    j = JFluxPipe.from_pretrained(
        root, shift=3.0, text_encoder=None, vae=None,
        transformer_cls=functools.partial(JArcFlux, dtype=jnp.float32))
    assert j.diffusion.timestep_sampler.use_dynamic_shifting is False


def test_wrong_family_folder_raises(folders, tmp_path, params):
    d = write_transformer(str(tmp_path / 'wrong'), 'qwen', params['qwen'])
    _write_json(os.path.join(d, 'config.json'), FLUX)
    with pytest.raises(ValueError, match='key maps'):
        ArcFluxPipeline.from_pretrained(d, **CPU)
    # a hub folder is read from the hub's local cache only
    # (utils/io_utils), which holds none of it: refused before a model of
    # the default size is built
    with pytest.raises(FileNotFoundError, match='no safetensors'):
        ArcFluxPipeline.from_pretrained('huggingface://org/repo', **CPU)


def test_class_name_and_teacher_folder(folders, params, tmp_path):
    """``_class_name`` picks the transformer (a Qwen folder through the
    FLUX pipeline class); a teacher-only folder's proj_out becomes the
    K-way means head, and the adapter then brings the other heads."""
    pipe = ArcFluxPipeline.from_pretrained(folders['qwen'], **CPU)
    assert type(pipe.transformer).__name__ == \
        'ArcQwenImageTransformer2DModel'
    p = jax_params_to_torch(params['flux'])
    teacher = {k: v for k, v in p.items()
               if not k.startswith('proj_out_')}
    teacher['proj_out.weight'] = p['proj_out_means.weight'][:16]
    teacher['proj_out.bias'] = p['proj_out_means.bias'][:16]
    from safetensors.torch import save_file
    from arcflow_tpu_torch.pipelines import torch_to_diffusers
    d = tmp_path / 'teacher'
    d.mkdir()
    save_file(torch_to_diffusers(teacher, num_gaussians=1),
              str(d / 'model.safetensors'))
    _write_json(str(d / 'config.json'), dict(FLUX, _class_name='x'))
    pipe = ArcFluxPipeline.from_pretrained(str(d), **CPU)
    w = pipe.transformer.proj_out_means.weight
    assert torch.equal(w[:16], teacher['proj_out.weight'])
    assert torch.equal(w[48:], teacher['proj_out.weight'])


def test_lora_on_a_model_without_lora_is_fused_not_dropped_as_in_jax(
        params, tmp_path):
    """An adapter's LoRA on a transformer built without LoRA is folded into
    the weights. A divergence from the reference: JAX's
    ``load_arcflow_adapter`` merges the leaves into its param tree
    (``arcflow_tpu/pipelines/arcflux_pipeline.py:293-312``), where a flax
    model built without LoRA never reads them, so the adapter's LoRA is
    dropped without a word."""
    p = jax_params_to_torch(params['flux'])
    cfg = {k: v for k, v in FLUX.items() if k != 'lora_rank'}
    model = ArcFluxTransformer2DModel(**cfg, **CPU)
    model.load_state_dict({k: v for k, v in p.items()
                           if not k.endswith(('.lora_a', '.lora_b'))})
    pipe = ArcFluxPipeline(model)
    lora = {k: v for k, v in p.items() if k.endswith(('.lora_a', '.lora_b'))}
    path = str(tmp_path / 'lora.safetensors')
    save_adapter_state(path, lora)
    pipe.load_arcflow_adapter(path)
    want = fuse_lora(p)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_cli_from_a_prompt_and_from_embeds(folders, params, family,
                                           tmp_path):
    import importlib
    cli = importlib.import_module(f'arcflow_tpu_torch.inference_{family}')
    png = str(tmp_path / 'x.png')
    te = ['--nfe', '2', '--seed', '3', '--height', '64', '--width', '64',
          '--device', 'cpu']
    assert cli.main(['--model-dir', folders[family + '_pipe'],
                     '--prompt', PROMPTS[0], '--out', png] + te) == 0
    with open(png, 'rb') as f:
        head = f.read(24)
    assert head[:8] == b'\x89PNG\r\n\x1a\n'
    assert int.from_bytes(head[16:20], 'big') == 16     # the VAEs' 2x
    apath = str(tmp_path / 'a.safetensors')
    save_adapter_state(apath, adapter(params[family], family),
                       policy_config=dict(nfe=2), family=family)
    epath = str(tmp_path / 'e.npz')
    np.savez(epath, **embeds(family))
    out = str(tmp_path / 'lat.npy')
    assert cli.main(['--model-dir', folders[family], '--adapter', apath,
                     '--prompt-embeds', epath, '--out', out, '--int8'] + te
                    ) == 0
    lat = np.load(out)
    assert lat.shape == (1, 8, 8, 4) and np.isfinite(lat).all()
    with pytest.raises(NotImplementedError, match='only sp'):
        cli.main(['--model-dir', folders[family], '--prompt-embeds', epath,
                  '--out', out, '--mesh', 'fsdp=2'] + te)
