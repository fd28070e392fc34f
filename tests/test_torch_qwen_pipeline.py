"""Port parity for the Qwen slice as a whole: ``ArcQwenImagePipeline``
(2-NFE ArcFlow sampling from prompt embeds and a text mask, then the Wan
decode) in arcflow_tpu_torch against the JAX package's pipeline, in float
and after ``quantize_int4(act_quant=True)`` (w4a8).

A tiny ArcQwen (2 joint blocks, 2 heads x 32, joint dim 64, K=4) and a tiny
Wan decoder get jittered JAX params, carried over to the port. Both
pipelines get the same latents and prompt embeds from numpy and run at
shift 3.1 and temperature 0.7. fp32 on both sides.

Tolerances: float latents rtol 2e-4, atol 5e-5 and images atol 1e-4, as in
tests/test_torch_pipeline.py. w4a8 latents: relative L2 1e-3, since an
activation one fp32 ulp apart on the two sides may round to a neighbouring
int8 step in either DiT call (tests/test_torch_qwen.py), and the second
call starts from latents the first one moved.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
from arcflow_tpu.models import PretrainedVAEQwenImage as JVAE
from arcflow_tpu.pipelines import arcflux_pipeline as jpipe
from arcflow_tpu.utils import quantize as jq
from arcflow_tpu_torch.models import ArcQwenImageTransformer2DModel as TArcQwen
from arcflow_tpu_torch.models import PretrainedVAEQwenImage as TVAE
from arcflow_tpu_torch.pipelines import (ArcQwenImagePipeline,
                                         jax_params_to_torch)

torch.set_num_threads(1)

CFG = dict(in_channels=16, num_layers=2, attention_head_dim=32,
           num_attention_heads=2, joint_attention_dim=64,
           axes_dims_rope=(8, 12, 12), max_text_len=6, num_gaussians=4,
           lora_rank=4)
JAX_ONLY = dict(patch_size=2, checkpointing=False, dtype=jnp.float32)
VAE_CFG = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1)
PIPE_CFG = dict(shift=3.1, nfe=2, temperature=0.7)
QUANT = dict(min_size=1024, group_size=32)
W4A8_REL_L2 = 1e-3


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


@pytest.fixture(scope='module')
def qwen_slice():
    rng = np.random.default_rng(11)
    latents = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    mask = np.ones((2, 8), np.int32)
    mask[0, 3:] = 0
    embeds = dict(encoder_hidden_states=rng.standard_normal(
        (2, 8, 64)).astype(np.float32), encoder_hidden_states_mask=mask)
    j_embeds = {k: jnp.asarray(v) for k, v in embeds.items()}

    jm = JArcQwen(**JAX_ONLY, **CFG)
    params = _jitter(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(latents), t=jnp.ones((2,)),
        **j_embeds)['params'])
    jv = JVAE(dtype='float32', **VAE_CFG)
    vparams = _jitter({
        'decoder': jax.jit(jv.decoder.init)(jax.random.PRNGKey(1),
                                            jnp.asarray(latents))['params'],
        'post_quant_conv': jax.jit(jv.post_quant_conv.init)(
            jax.random.PRNGKey(2), jnp.asarray(latents))['params']}, seed=8)
    jp = jpipe.ArcQwenImagePipeline(jm, params, vae=jv, vae_params=vparams,
                                    **PIPE_CFG)
    j_lat = jp(prompt_embeds=j_embeds, latents=jnp.asarray(latents),
               output_type='latent')['latents']
    j_img = jp(prompt_embeds=j_embeds, latents=jnp.asarray(latents))['images']

    def port_pipe():
        tm = TArcQwen(dtype=torch.float32, **CFG)
        tm.load_state_dict(jax_params_to_torch(params), strict=True)
        tv = TVAE(dtype=torch.float32, **VAE_CFG)
        tv.load_state_dict(jax_params_to_torch(vparams), strict=True)
        return ArcQwenImagePipeline(tm, vae=tv, **PIPE_CFG)

    tp = port_pipe()
    t_embeds = {k: torch.from_numpy(v) for k, v in embeds.items()}
    t_lat = tp(prompt_embeds=t_embeds, latents=torch.from_numpy(latents),
               output_type='latent')['latents']
    t_img = tp(prompt_embeds=t_embeds,
               latents=torch.from_numpy(latents))['images']
    return SimpleNamespace(
        j_lat=np.asarray(j_lat), j_img=np.asarray(j_img), t_lat=t_lat.numpy(),
        t_img=t_img, noise=latents, embeds=embeds, j_embeds=j_embeds,
        t_embeds=t_embeds, jm=jm, params=params, jv=jv, vparams=vparams,
        tp=tp, port_pipe=port_pipe)


def test_two_nfe_latents_match_jax(qwen_slice):
    s = qwen_slice
    assert s.t_lat.shape == s.j_lat.shape == s.noise.shape
    assert np.abs(s.t_lat - s.noise).max() > 0.1   # the sampler moved x
    np.testing.assert_allclose(s.t_lat, s.j_lat, rtol=2e-4, atol=5e-5)


def test_decoded_images_match_jax(qwen_slice):
    s = qwen_slice
    assert isinstance(s.t_img, np.ndarray)
    assert s.t_img.shape == s.j_img.shape == (2, 32, 32, 3)
    assert s.t_img.min() >= 0.0 and s.t_img.max() <= 1.0
    np.testing.assert_allclose(s.t_img, s.j_img, rtol=0, atol=1e-4)


def test_no_guidance_reaches_the_qwen_model(qwen_slice):
    """Qwen has no guidance embeds: the pipeline passes the model exactly
    the prompt embeds, with the text mask and without ``guidance``."""
    s = qwen_slice
    seen = []
    hook = s.tp.transformer.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.append(sorted(kwargs)),
        with_kwargs=True)
    try:
        s.tp(prompt_embeds=s.t_embeds, latents=torch.from_numpy(s.noise),
             output_type='latent')
    finally:
        hook.remove()
    assert seen == [['encoder_hidden_states', 'encoder_hidden_states_mask']] * 2


def test_w4a8_pipeline_matches_jax(qwen_slice):
    """``quantize_int4(act_quant=True)`` on both pipelines: the port's mode
    is state of its layers, JAX's a process-wide flag (restored here)."""
    s = qwen_slice
    jp = jpipe.ArcQwenImagePipeline(s.jm, s.params, **PIPE_CFG)
    try:
        jp.quantize_int4(act_quant=True, **QUANT)
        want = np.asarray(jp(prompt_embeds=s.j_embeds,
                             latents=jnp.asarray(s.noise),
                             output_type='latent')['latents'])
    finally:
        jq.set_act_quant(False)
    tp = s.port_pipe()
    assert tp.quantize_int4(act_quant=True, **QUANT) == \
        14 * CFG['num_layers'] + 3
    got = tp(prompt_embeds=s.t_embeds, latents=torch.from_numpy(s.noise),
             output_type='latent')['latents'].numpy()
    assert np.abs(got - s.t_lat).max() > 1e-3       # quantization shows
    assert np.linalg.norm(got - want) <= W4A8_REL_L2 * np.linalg.norm(want)
