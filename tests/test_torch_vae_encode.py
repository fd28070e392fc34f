"""Port parity: the VAE encoders. ``PretrainedVAE.encode`` (the
AutoencoderKL ``Encoder`` with ``Downsample`` and ``quant_conv``) and
``PretrainedVAEQwenImage.encode`` (the Wan ``QwenVAEEncoder`` with
``WanDownsample`` and the quant conv) against the JAX package, the
posterior's mean and a draw from the same noise; and the encoder halves of
the diffusers-key maps against JAX's ``torch_vae_to_flax`` /
``torch_qwen_vae_to_flax``, key for key, loaded by ``from_pretrained``.

Tiny encoders in fp32 on both sides, from jittered JAX params carried over
with ``jax_params_to_torch`` and loaded with ``strict=True``. Tolerance
rtol 2e-4, atol 1e-4, as ``tests/test_torch_vae.py`` holds the decoders;
the maps are bitwise.
"""

import functools
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import PretrainedVAE as JVAE
from arcflow_tpu.models import PretrainedVAEQwenImage as JQwenVAE
from arcflow_tpu.pipelines import convert as jconv
from arcflow_tpu_torch.models import (PretrainedVAE, PretrainedVAEEncoder,
                                      PretrainedVAEQwenImage)
from arcflow_tpu_torch.pipelines import (diffusers_qwen_vae_to_torch,
                                         diffusers_vae_to_torch,
                                         jax_params_to_torch)
from test_vae_convert import synth_autoencoder_kl_state, synth_qwen_vae_state

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-4)
FLUX_CFG = dict(latent_channels=4, block_out_channels=(32, 64),
                layers_per_block=1)
WAN_CFG = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1)
STATS = dict(latents_mean=[0.1, -0.2, 0.3, 0.0],
             latents_std=[1.5, 0.5, 2.0, 1.0])


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


def _images(hw=16, seed=1):
    return np.random.default_rng(seed).uniform(
        -1, 1, (2, hw, hw, 3)).astype(np.float32)


def _encoder_params(jv, hw=16):
    """Jittered params of ``jv``'s encoder and quant conv (initialised
    under jit: flax's eager init of a whole VAE is slow)."""
    c2 = 2 * jv.latent_channels
    return _jitter({
        'encoder': jax.jit(jv.encoder.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)))['params'],
        'quant_conv': jax.jit(jv.quant_conv.init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 1, 1, c2)))['params']})


def _compare(jv, params, tv, images):
    """The mean (no generator / rng) and a draw from JAX's noise."""
    jimg = jnp.asarray(images)
    want_mean = np.asarray(jax.jit(jv.encode)(params, jimg))
    with torch.no_grad():
        got_mean = tv.encode(torch.from_numpy(images))
    assert got_mean.dtype == torch.float32
    np.testing.assert_allclose(got_mean.numpy(), want_mean, **TOL)

    jv.sample_posterior = True
    rng = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(jv.encode)(params, jimg, rng))
    eps = np.array(jax.random.normal(rng, want.shape, jnp.float32))
    eps_nchw = torch.from_numpy(eps).permute(0, 3, 1, 2)

    def randn(shape, generator=None, device=None, dtype=None):
        assert generator is not None and tuple(shape) == eps_nchw.shape
        return eps_nchw.to(dtype)
    with torch.no_grad(), mock.patch.object(torch, 'randn', randn):
        got = tv.encode(torch.from_numpy(images), torch.Generator())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(got.numpy() - got_mean.numpy()).max() > 1e-3


@functools.lru_cache(maxsize=None)
def _flux_params():
    """Jittered params of the tiny AutoencoderKL encoder and quant conv,
    shared by both normalizations (they do not change the parameters)."""
    return _encoder_params(JVAE(dtype='float32', use_quant_conv=True,
                                **FLUX_CFG))


@pytest.mark.parametrize('stats', [{}, STATS], ids=['scale_shift', 'stats'])
def test_flux_encode_matches_jax(stats):
    jv = JVAE(dtype='float32', use_quant_conv=True, **FLUX_CFG, **stats)
    params = _flux_params()
    tv = PretrainedVAEEncoder(dtype=torch.float32, use_quant_conv=True,
                              **FLUX_CFG, **stats)
    tv.load_state_dict(jax_params_to_torch(params), strict=True)
    assert tv.decoder is None
    _compare(jv, params, tv, _images())


@functools.lru_cache(maxsize=None)
def _wan():
    """The tiny Wan VAE of JAX and its jittered encoder params, shared by
    the tests that encode with it."""
    jv = JQwenVAE(dtype='float32', **WAN_CFG, **STATS)
    return jv, _encoder_params(jv)


def test_wan_encode_matches_jax():
    jv, params = _wan()
    tv = PretrainedVAEQwenImage(dtype=torch.float32, with_encoder=True,
                                **WAN_CFG, **STATS)
    own = {k: v for k, v in tv.state_dict().items()
           if k.startswith(('encoder.', 'quant_conv.'))}
    conv = jax_params_to_torch(params)
    assert set(own) == set(conv)
    tv.load_state_dict(conv, strict=False)
    _compare(jv, params, tv, _images())


def test_decoder_only_vaes_refuse_encode():
    for vae in (PretrainedVAE(dtype=torch.float32, **FLUX_CFG),
                PretrainedVAEQwenImage(dtype=torch.float32, **WAN_CFG)):
        assert vae.encoder is None
        with pytest.raises(RuntimeError, match='decoder-only'):
            vae.encode(torch.zeros(1, 16, 16, 3))


def _flat(tree):
    return jax_params_to_torch(tree)


def test_flux_encoder_map_equals_jax():
    state = synth_autoencoder_kl_state(block_out=(32, 64), layers=1, z=4)
    got, unused = diffusers_vae_to_torch(state, encoder=True)
    want = _flat(jconv.torch_vae_to_flax(state)[0])
    assert set(got) == set(want) and not unused
    for k in got:
        assert torch.equal(got[k], want[k]), k
    vae = PretrainedVAE(dtype=torch.float32, with_encoder=True,
                        use_quant_conv=True, use_post_quant_conv=True,
                        **FLUX_CFG)
    vae.load_state_dict(got, strict=True)


def test_wan_encoder_map_equals_jax():
    state = synth_qwen_vae_state(base=32, mult=(1, 2), nres=1, z=4)
    got, unused = diffusers_qwen_vae_to_torch(state, encoder=True)
    want = _flat(jconv.torch_qwen_vae_to_flax(state)[0])
    assert set(got) == set(want)
    assert not any('.time_conv.' in k for k in got)
    assert all('.time_conv.' in k for k in unused)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    vae = PretrainedVAEQwenImage(base_dim=32, z_dim=4, dim_mult=(1, 2),
                                 num_res_blocks=1, with_encoder=True,
                                 dtype=torch.float32)
    vae.load_state_dict(got, strict=True)


def test_encoder_loads_from_a_diffusers_folder(tmp_path):
    """``from_pretrained`` loads the encoder half of a folder into an
    encoder VAE, and the decoder half alone into a decoder-only one."""
    from safetensors.numpy import save_file
    state = synth_autoencoder_kl_state(block_out=(32, 64), layers=1, z=4)
    save_file(state, str(tmp_path / 'diffusion_pytorch_model.safetensors'))
    with open(os.path.join(tmp_path, 'config.json'), 'w') as f:
        json.dump(dict(FLUX_CFG), f)
    enc = PretrainedVAEEncoder(from_pretrained=str(tmp_path),
                               use_quant_conv=True, dtype=torch.float32,
                               **FLUX_CFG)
    want, _ = diffusers_vae_to_torch(state, encoder=True)
    for k, v in enc.state_dict().items():
        assert torch.equal(v, want[k]), k
    dec = PretrainedVAE(from_pretrained=str(tmp_path),
                        use_post_quant_conv=True, dtype=torch.float32,
                        **FLUX_CFG)
    assert dec.encoder is None and set(dec.state_dict()) <= set(want)


def test_composition_encodes_images_as_jax():
    """``LatentDiffusionTextImage`` takes latents from ``images`` (in [0,
    1]) through its VAE's ``encode`` of ``images * 2 - 1``, the mean, as
    JAX's ``_latents`` does."""
    import copy
    from arcflow_tpu.models import LatentDiffusionTextImage as JModel
    from arcflow_tpu_torch.models import LatentDiffusionTextImage
    from test_torch_qwen_train import model_cfg
    vae = dict(type='PretrainedVAEQwenImage', dtype='float32', **WAN_CFG,
               **STATS)
    cfg = dict(model_cfg(), vae=vae, latent_shape=(4, 4, 4))
    jm = JModel(**copy.deepcopy(cfg))
    params = _wan()[1]
    images = (_images() + 1) / 2
    want = np.asarray(jax.jit(lambda x, p: jm._latents({'images': x},
                                                       {'vae': p}))(
        jnp.asarray(images), params))
    model = LatentDiffusionTextImage(
        device='cpu', dtype=torch.float32,
        **dict(copy.deepcopy(cfg), vae=dict(vae, with_encoder=True)))
    conv = jax_params_to_torch(params)
    model.vae.load_state_dict(conv, strict=False)
    assert set(conv) <= set(model.vae.state_dict())
    got = model._latents({'images': torch.from_numpy(images)})
    assert got.shape == (2, 4, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
