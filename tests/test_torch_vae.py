"""Port parity: the AutoencoderKL decoder and ``PretrainedVAE.decode``
(arcflow_tpu_torch.models.vae) against the JAX package.

The decoder runs at block_out_channels=(32, 64) (the 32-group GroupNorm's
smallest widths), fp32 on both sides, from jittered JAX params carried over
with ``jax_params_to_torch`` and loaded with ``strict=True``. Tolerance
rtol=2e-4, atol=1e-4: fp32 convolutions summed in another order through
about twenty conv and norm layers (outputs are O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from arcflow_tpu.models import PretrainedVAE as JVAE
from arcflow_tpu.models import vae as jvae
from arcflow_tpu_torch.models import PretrainedVAE as TVAE
from arcflow_tpu_torch.models import vae as tvae
from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-4)


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


def test_decode_matches_jax():
    cfg = dict(latent_channels=4, block_out_channels=(32, 64))
    jv = JVAE(dtype='float32', **cfg)
    z = np.random.default_rng(1).standard_normal((2, 4, 5, 4)).astype(
        np.float32)
    params = _jitter({'decoder': jax.jit(jv.decoder.init)(
        jax.random.PRNGKey(0), jnp.asarray(z))['params']})
    tv = TVAE(dtype=torch.float32, **cfg)
    tv.load_state_dict(jax_params_to_torch(params), strict=True)
    want = np.asarray(jax.jit(jv.decode)(params, jnp.asarray(z)))
    with torch.no_grad():
        got = tv.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 8, 10, 3)
    np.testing.assert_allclose(got, want, **TOL)


def _block_pair(flax_mod, torch_mod, x_nhwc):
    params = _jitter(jax.jit(flax_mod.init)(
        jax.random.PRNGKey(0), jnp.asarray(x_nhwc))['params'])
    torch_mod.load_state_dict(jax_params_to_torch(params), strict=True)
    want = np.asarray(flax_mod.apply({'params': params}, jnp.asarray(x_nhwc)))
    with torch.no_grad():
        got = torch_mod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want


def test_resnet_block_with_shortcut_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 64)).astype(
        np.float32)
    np.testing.assert_allclose(*_block_pair(
        jvae.ResnetBlock(32, dtype=jnp.float32), tvae.ResnetBlock(64, 32), x),
        **TOL)


def test_attn_block_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 32)).astype(
        np.float32)
    np.testing.assert_allclose(*_block_pair(
        jvae.AttnBlock(32, dtype=jnp.float32), tvae.AttnBlock(32), x), **TOL)


def test_upsample_matches_jax():
    x = np.random.default_rng(4).standard_normal((1, 3, 4, 32)).astype(
        np.float32)
    np.testing.assert_allclose(*_block_pair(
        jvae.Upsample(32, dtype=jnp.float32), tvae.Upsample(32), x), **TOL)
