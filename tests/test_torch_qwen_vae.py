"""Port parity: the Wan decoder and ``PretrainedVAEQwenImage.decode``
(arcflow_tpu_torch.models.qwen_vae) against the JAX package.

A tiny decoder (base 8, z 4, dim_mult (1, 2, 2), one res block, so two
upsamples, the mid attention and the width-halving upsample all run) in
fp32 on both sides, from jittered JAX params carried over with
``jax_params_to_torch`` and loaded with ``strict=True``, with per-channel
latent mean/std. Tolerance rtol 2e-4, atol 1e-4 as in
tests/test_torch_vae.py: fp32 convolutions summed in another order through
about twenty conv and norm layers (outputs are O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from arcflow_tpu.models import PretrainedVAEQwenImage as JVAE
from arcflow_tpu.models import qwen_vae as jwan
from arcflow_tpu_torch.models import PretrainedVAEQwenImage as TVAE
from arcflow_tpu_torch.models import qwen_vae as twan
from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-4)
CFG = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1)
STATS = dict(latents_mean=[0.1, -0.2, 0.3, 0.0],
             latents_std=[1.5, 0.5, 2.0, 1.0])


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


def test_decode_matches_jax():
    jv = JVAE(dtype='float32', **CFG, **STATS)
    z = np.random.default_rng(1).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    params = _jitter({
        'decoder': jax.jit(jv.decoder.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(z))['params'],
        'post_quant_conv': jax.jit(jv.post_quant_conv.init)(
            jax.random.PRNGKey(1), jnp.asarray(z))['params']})
    tv = TVAE(dtype=torch.float32, **CFG, **STATS)
    tv.load_state_dict(jax_params_to_torch(params), strict=True)
    want = np.asarray(jax.jit(jv.decode)(params, jnp.asarray(z)))
    with torch.no_grad():
        got = tv.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 12, 20, 3)
    np.testing.assert_allclose(got, want, **TOL)


def _block_pair(flax_mod, torch_mod, x_nhwc):
    params = _jitter(jax.jit(flax_mod.init)(
        jax.random.PRNGKey(0), jnp.asarray(x_nhwc))['params'])
    torch_mod.load_state_dict(jax_params_to_torch(params), strict=True)
    want = np.asarray(flax_mod.apply({'params': params}, jnp.asarray(x_nhwc)))
    with torch.no_grad():
        got = torch_mod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want


def test_residual_block_with_shortcut_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 16)).astype(
        np.float32)
    np.testing.assert_allclose(*_block_pair(
        jwan.WanResidualBlock(8, dtype=jnp.float32),
        twan.WanResidualBlock(16, 8), x), **TOL)


def test_attention_block_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 16)).astype(
        np.float32)
    np.testing.assert_allclose(*_block_pair(
        jwan.WanAttentionBlock(16, dtype=jnp.float32),
        twan.WanAttentionBlock(16), x), **TOL)


def test_upsample_halves_the_width_as_jax():
    x = np.random.default_rng(4).standard_normal((1, 3, 4, 16)).astype(
        np.float32)
    got, want = _block_pair(jwan.WanUpsample(16, dtype=jnp.float32),
                            twan.WanUpsample(16), x)
    assert got.shape == want.shape == (1, 6, 8, 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_rms_norm_adds_eps_after_the_root():
    """An all-zero pixel stays 0 (the eps sits outside the square root);
    elsewhere the norm matches JAX."""
    x = np.random.default_rng(5).standard_normal((1, 2, 3, 8)).astype(
        np.float32)
    x[0, 0, 0] = 0.0
    got, want = _block_pair(jwan.WanRMSNorm(8), twan.WanRMSNorm(8), x)
    assert not got[0, 0, 0].any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
