"""Port parity for the slice as a whole: ``ArcFluxPipeline`` (2-NFE ArcFlow
sampling from prompt embeds, then VAE decode) in arcflow_tpu_torch against
the JAX package's pipeline, plus the port's freedom from JAX.

A tiny ArcFlux (2 joint + 2 single blocks, 2 heads x 16, K=4) and a tiny
VAE decoder get jittered JAX params, carried over to the port. Both
pipelines get the same latents and prompt embeds from numpy (JAX and torch
RNGs differ) and run at temperature 0.7, so the per-step temperature (on
the first step, not on the last) is exercised. fp32 on both sides.
Tolerances: latents rtol=2e-4, atol=5e-5 (fp32 matmuls in another order,
through two DiT calls and the integrator); images atol=1e-4 (the decoder
adds its fp32 conv rounding; values are in [0, 1]).
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.diffusion import \
    ArcFlowImitationDataFree as JArcFlow
from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
from arcflow_tpu.models import PretrainedVAE as JVAE
from arcflow_tpu.pipelines import arcflux_pipeline as jpipe
from arcflow_tpu_torch.diffusion import ArcFlowImitationDataFree as TArcFlow
from arcflow_tpu_torch.diffusion import ContinuousTimeStepSampler as TSampler
from arcflow_tpu_torch.models import ArcFluxTransformer2DModel as TArcFlux
from arcflow_tpu_torch.models import PretrainedVAE as TVAE
from arcflow_tpu_torch.pipelines import (ArcFluxPipeline, jax_params_to_torch,
                                         retrieve_raw_timesteps)

torch.set_num_threads(1)

CFG = dict(in_channels=16, num_layers=2, num_single_layers=2,
           attention_head_dim=16, num_attention_heads=2,
           joint_attention_dim=24, pooled_projection_dim=16,
           axes_dims_rope=(4, 6, 6), num_gaussians=4)
# fixed in the port (FLUX.1-dev's values), fields of the JAX model
JAX_ONLY = dict(guidance_embeds=True, patch_size=2, checkpointing=False,
                dtype=jnp.float32)
VAE_CFG = dict(latent_channels=4, block_out_channels=(32, 64))
PIPE_CFG = dict(shift=3.2, nfe=2, temperature=0.7, guidance_scale=3.5)


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


@pytest.fixture(scope='module')
def slice_pair():
    rng = np.random.default_rng(11)
    f = np.float32
    latents = rng.standard_normal((2, 8, 8, 4)).astype(f)
    embeds = dict(encoder_hidden_states=rng.standard_normal((2, 5, 24)
                                                            ).astype(f),
                  pooled_projections=rng.standard_normal((2, 16)).astype(f))

    jm = JArcFlux(**JAX_ONLY, **CFG)
    params = _jitter(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(latents), t=jnp.ones((2,)),
        guidance=jnp.ones((2,)),
        **{k: jnp.asarray(v) for k, v in embeds.items()})['params'])
    jv = JVAE(dtype='float32', **VAE_CFG)
    vparams = _jitter({'decoder': jax.jit(jv.decoder.init)(
        jax.random.PRNGKey(1), jnp.asarray(latents))['params']}, seed=8)
    jp = jpipe.ArcFluxPipeline(jm, params, vae=jv, vae_params=vparams,
                               **PIPE_CFG)
    j_embeds = {k: jnp.asarray(v) for k, v in embeds.items()}
    j_lat = jp(prompt_embeds=j_embeds, latents=jnp.asarray(latents),
               output_type='latent')['latents']
    j_img = jp(prompt_embeds=j_embeds, latents=jnp.asarray(latents))['images']

    tm = TArcFlux(dtype=torch.float32, **CFG)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    tv = TVAE(dtype=torch.float32, **VAE_CFG)
    tv.load_state_dict(jax_params_to_torch(vparams), strict=True)
    tp = ArcFluxPipeline(tm, vae=tv, **PIPE_CFG)
    t_embeds = {k: torch.from_numpy(v) for k, v in embeds.items()}
    t_lat = tp(prompt_embeds=t_embeds, latents=torch.from_numpy(latents),
               output_type='latent')['latents']
    t_img = tp(prompt_embeds=t_embeds,
               latents=torch.from_numpy(latents))['images']
    return SimpleNamespace(
        j_lat=np.asarray(j_lat), j_img=np.asarray(j_img),
        t_lat=t_lat.numpy(), t_img=t_img, noise=latents, embeds=embeds,
        jm=jm, params=params, tm=tm, tp=tp, t_embeds=t_embeds)


def test_two_nfe_latents_match_jax(slice_pair):
    sp = slice_pair
    assert sp.t_lat.shape == sp.j_lat.shape == sp.noise.shape
    assert np.abs(sp.t_lat - sp.noise).max() > 0.1   # the sampler moved x
    np.testing.assert_allclose(sp.t_lat, sp.j_lat, rtol=2e-4, atol=5e-5)


def test_decoded_images_match_jax(slice_pair):
    sp = slice_pair
    assert isinstance(sp.t_img, np.ndarray)
    assert sp.t_img.shape == sp.j_img.shape == (2, 16, 16, 3)  # 2 levels
    assert sp.t_img.min() >= 0.0 and sp.t_img.max() <= 1.0
    np.testing.assert_allclose(sp.t_img, sp.j_img, rtol=0, atol=1e-4)


def test_temperature_changes_the_sample(slice_pair):
    """The per-step temperature reaches the policy: overriding it to 1 per
    call moves the port's latents away from the run at 0.7, by far more
    than the parity tolerance."""
    sp = slice_pair
    out = sp.tp(prompt_embeds=sp.t_embeds, latents=torch.from_numpy(sp.noise),
                temperature=1.0, output_type='latent')['latents'].numpy()
    assert np.abs(out - sp.j_lat).max() > 1e-2


def test_forward_test_matches_jax_dynamic_shift(slice_pair):
    """``forward_test`` alone, off the pipeline's defaults: 3 NFE with the
    final segment scaled by timestep_ratio 0.5, dynamic shifting by the
    token count, temperature 0.8 on the first two steps. Tolerance as for
    the pipeline's latents."""
    sp = slice_pair
    cfg = dict(nfe=3, timestep_ratio=0.5, temperature=0.8)
    guidance = np.full((2,), 2.0, np.float32)
    jd = JArcFlow(denoising=sp.jm, num_timesteps=1, test_cfg=cfg,
                  timestep_sampler=dict(type='ContinuousTimeStepSampler',
                                        use_dynamic_shifting=True))
    want = jax.jit(lambda p, x, **kw: jd.forward_test(p, None, x, **kw))(
        sp.params, jnp.asarray(sp.noise), guidance=jnp.asarray(guidance),
        **{k: jnp.asarray(v) for k, v in sp.embeds.items()})
    td = TArcFlow(denoising=sp.tm, num_timesteps=1, test_cfg=cfg,
                  timestep_sampler=TSampler(use_dynamic_shifting=True))
    got = td.forward_test(torch.from_numpy(sp.noise),
                          guidance=torch.from_numpy(guidance),
                          **sp.t_embeds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=5e-5)


@pytest.mark.parametrize('nfe,ratio', [(2, 1.0), (3, 0.5), (1, 1.0)])
def test_retrieve_raw_timesteps_matches_jax(nfe, ratio):
    t_raw, t_sub = retrieve_raw_timesteps(nfe, 128, ratio)
    j_raw, j_sub = jpipe.retrieve_raw_timesteps(nfe, 128, ratio)
    np.testing.assert_array_equal(t_raw, j_raw)
    assert t_sub == j_sub


def test_prepare_latents_is_seeded_by_the_generator():
    tp = ArcFluxPipeline(TArcFlux(dtype=torch.float32, **CFG))
    a = tp.prepare_latents(1, 64, 48, torch.Generator().manual_seed(3))
    b = tp.prepare_latents(1, 64, 48, torch.Generator().manual_seed(3))
    assert a.shape == (1, 8, 6, 4) and a.dtype == torch.float32
    assert torch.equal(a, b)


def test_port_imports_no_jax():
    code = ('import sys, arcflow_tpu_torch, arcflow_tpu_torch.diffusion, '
            'arcflow_tpu_torch.models, arcflow_tpu_torch.pipelines, '
            'arcflow_tpu_torch.ops.attention, arcflow_tpu_torch.ops._build; '
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "arcflow_tpu")); '
            'assert not bad, bad')
    res = subprocess.run([sys.executable, '-c', code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
