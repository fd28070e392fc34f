"""Port parity: DiT building blocks (arcflow_tpu_torch.models.layers) against
their flax modules in arcflow_tpu.models.layers.

Each flax module is initialised at a tiny width in fp32, its params are
jittered (so zero-initialised kernels are non-trivial) and carried over with
``jax_params_to_torch``; the port module loads them with ``strict=True`` and
both run on the same numpy inputs. Tolerance rtol=2e-4, atol=2e-5 (the
level of tests/test_torch_block_parity.py): fp32 matmuls summed in another
order by XLA and by PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import layers as jl
from arcflow_tpu_torch.models import layers as tl
from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
DIM, HEADS, HEAD_DIM = 32, 2, 16


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


def _pair(flax_mod, torch_mod, *inputs):
    """(flax outputs, torch outputs) of both modules on the same inputs."""
    j_in = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in inputs]
    params = _jitter(jax.jit(flax_mod.init)(jax.random.PRNGKey(0),
                                             *j_in)['params'])
    torch_mod.load_state_dict(jax_params_to_torch(params), strict=True)
    j_out = flax_mod.apply({'params': params}, *j_in)
    t_in = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in inputs]
    with torch.no_grad():
        t_out = torch_mod(*t_in)
    return j_out, t_out


def _close(t_out, j_out):
    j_out = j_out if isinstance(j_out, tuple) else (j_out,)
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    assert len(t_out) == len(j_out)
    for a, r in zip(t_out, j_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


def test_timestep_sinusoidal_matches_jax():
    t = np.array([0.0, 250.0, 999.0], np.float32)
    np.testing.assert_allclose(
        tl.timestep_sinusoidal(torch.from_numpy(t), 256).numpy(),
        np.asarray(jl.timestep_sinusoidal(jnp.asarray(t), 256)), **TOL)


@pytest.mark.parametrize('lora_rank', [0, 4])
def test_lora_dense_matches_jax(lora_rank):
    _close(*reversed(_pair(
        jl.LoRADense(24, lora_rank=lora_rank, dtype=jnp.float32),
        tl.LoRADense(DIM, 24, lora_rank=lora_rank), _np((2, 5, DIM), 1))))


def test_rms_norm_matches_jax():
    _close(*reversed(_pair(jl.RMSNorm(HEAD_DIM, dtype=jnp.float32),
                           tl.RMSNorm(HEAD_DIM), _np((2, 5, 2, HEAD_DIM), 2))))


def test_layer_norm_no_affine_matches_jax():
    x = 3.0 + _np((2, 5, DIM), 3)
    np.testing.assert_allclose(
        tl.layer_norm_no_affine(torch.from_numpy(x)).numpy(),
        np.asarray(jl.layer_norm_no_affine(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize('name', ['AdaLayerNormZero', 'AdaLayerNormZeroSingle',
                                  'AdaLayerNormContinuous'])
def test_adaln_matches_jax(name):
    _close(*reversed(_pair(getattr(jl, name)(DIM, dtype=jnp.float32),
                           getattr(tl, name)(DIM),
                           _np((2, 5, DIM), 4), _np((2, DIM), 5))))


@pytest.mark.parametrize('lora_rank', [0, 4])
def test_feed_forward_matches_jax(lora_rank):
    _close(*reversed(_pair(
        jl.FeedForward(DIM, lora_rank=lora_rank, dtype=jnp.float32),
        tl.FeedForward(DIM, lora_rank=lora_rank), _np((2, 5, DIM), 6))))


def _ids(s_txt=3, h=2, w=3):
    img = np.stack(np.meshgrid(np.zeros(1), np.arange(h), np.arange(w),
                               indexing='ij'), -1).reshape(-1, 3)
    return np.concatenate([np.zeros((s_txt, 3)), img]).astype(np.int32)


def test_rope_matches_jax():
    ids = _ids()
    j_cos, j_sin = jl.rope_frequencies(jnp.asarray(ids), (4, 6, 6))
    t_cos, t_sin = tl.rope_frequencies(torch.from_numpy(ids), (4, 6, 6))
    np.testing.assert_allclose(t_cos.numpy(), np.asarray(j_cos), **TOL)
    np.testing.assert_allclose(t_sin.numpy(), np.asarray(j_sin), **TOL)
    x = _np((2, ids.shape[0], HEADS, HEAD_DIM), 7)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), t_cos[None, :, None],
                      t_sin[None, :, None]).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), j_cos[None, :, None],
                                 j_sin[None, :, None])), **TOL)


def _rope_pair(ids):
    j = jl.rope_frequencies(jnp.asarray(ids), (4, 6, 6))
    t = tl.rope_frequencies(torch.from_numpy(ids), (4, 6, 6))
    return j, t


def test_joint_attention_matches_jax():
    ids = _ids(s_txt=3)
    (j_rope, t_rope) = _rope_pair(ids)
    img, txt = _np((2, 6, DIM), 8), _np((2, 3, DIM), 9)
    fm = jl.JointAttention(DIM, HEADS, HEAD_DIM, dtype=jnp.float32)
    params = _jitter(jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.asarray(img),
                                      jnp.asarray(txt), j_rope)['params'])
    tm = tl.JointAttention(DIM, HEADS, HEAD_DIM)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    j_out = fm.apply({'params': params}, jnp.asarray(img), jnp.asarray(txt),
                     j_rope)
    with torch.no_grad():
        t_out = tm(torch.from_numpy(img), torch.from_numpy(txt), t_rope)
    _close(t_out, j_out)


def test_single_stream_attention_matches_jax():
    ids = _ids(s_txt=3)
    (j_rope, t_rope) = _rope_pair(ids)
    x = _np((2, 9, DIM), 10)
    fm = jl.SingleStreamAttention(DIM, HEADS, HEAD_DIM, dtype=jnp.float32)
    params = _jitter(jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                      j_rope)['params'])
    tm = tl.SingleStreamAttention(DIM, HEADS, HEAD_DIM)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    j_out = fm.apply({'params': params}, jnp.asarray(x), j_rope)
    with torch.no_grad():
        t_out = tm(torch.from_numpy(x), t_rope)
    _close(t_out, j_out)


def test_key_padding_mask_matches_jax():
    kv = np.arange(8)[None, :] < np.array([[5], [8]])
    got = tl.key_padding_mask(torch.from_numpy(kv)[:, None, None, :], 8)
    want = jl.key_padding_mask(jnp.asarray(kv)[:, None, None, :], 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = torch.ones(2, 1, 8, 8, dtype=torch.bool)
    assert tl.key_padding_mask(full, 8) is None
    assert tl.key_padding_mask(None, 8) is None
