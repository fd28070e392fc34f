"""Port parity: the attention kernel's plain version and its wrapper
(arcflow_tpu_torch.ops.attention) against the JAX package.

On the CPU the wrapper takes the plain version, which is what these tests
hold against the Pallas flash kernel (run in interpret mode, as
tests/test_flash_attention.py runs it) and against XLA attention. The
kernel itself runs only on a CUDA card: its tests are in
test_torch_attention_cuda.py, which imports no JAX.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcflow_tpu.models.layers import _flash_call
from arcflow_tpu.models.layers import attention as j_attention
from arcflow_tpu_torch.models import layers as t_layers
from arcflow_tpu_torch.ops import _build
from arcflow_tpu_torch.ops import attention as t_attn

torch.set_num_threads(1)


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _ref(q, k, v, kv_valid=None, return_lse=False):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = t_attn.attention_ref(t(q), t(k), t(v), t(kv_valid),
                               return_lse=return_lse)
    return tuple(o.numpy() for o in out) if return_lse else out.numpy()


def test_attention_ref_matches_pallas_flash_unmasked():
    """atol 2e-3, as tests/test_flash_attention.py holds the Pallas kernel
    to XLA: the interpreted kernel accumulates over 512-wide key blocks in
    another order than one fp32 softmax."""
    q, k, v = _qkv(2, 512, 2, 128, seed=0)
    with pltpu.force_tpu_interpret_mode():
        ref = _flash_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(_ref(q, k, v), np.asarray(ref), atol=2e-3)


def test_attention_ref_matches_pallas_flash_key_padded():
    """Per-sample key padding, lowered to segment ids on the JAX side."""
    q, k, v = _qkv(2, 512, 2, 128, seed=1)
    kv_valid = np.arange(512)[None, :] < np.array([[412], [475]])
    with pltpu.force_tpu_interpret_mode():
        ref = _flash_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          kv_valid=jnp.asarray(kv_valid))
    np.testing.assert_allclose(_ref(q, k, v, kv_valid), np.asarray(ref),
                               atol=2e-3)


@pytest.mark.parametrize('masked', [False, True])
def test_attention_ref_matches_xla_at_ragged_s(masked):
    """S = 77 is no multiple of any tile. fp32 on both sides: rtol 2e-5,
    atol 2e-6 cover the softmax's last-bit rounding."""
    q, k, v = _qkv(2, 77, 3, 32, seed=2)
    kv_valid = (np.arange(77)[None, :] < np.array([[50], [77]])) \
        if masked else None
    ref = jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if kv_valid is None
        else jnp.asarray(kv_valid)[:, None, None, :])
    np.testing.assert_allclose(_ref(q, k, v, kv_valid), np.asarray(ref),
                               rtol=2e-5, atol=2e-6)


def test_attention_ref_lse_is_logsumexp():
    q, k, v = _qkv(2, 77, 2, 16, seed=3)
    kv_valid = np.arange(77)[None, :] < np.array([[30], [77]])
    _, lse = _ref(q, k, v, kv_valid, return_lse=True)
    logits = np.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(16)
    logits = np.where(kv_valid[:, None, None, :], logits, -np.inf)
    want = jax.scipy.special.logsumexp(jnp.asarray(logits), axis=-1)
    assert lse.shape == (2, 2, 77)
    np.testing.assert_allclose(lse, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_attention_ref_row_without_valid_key_is_zero():
    """The defined output for a fully masked row: O = 0, LSE = -inf (the
    kernel's choice; plain softmax would give NaN)."""
    q, k, v = _qkv(2, 9, 2, 16, seed=4)
    kv_valid = np.ones((2, 9), bool)
    kv_valid[1] = False
    out, lse = _ref(q, k, v, kv_valid, return_lse=True)
    assert np.all(out[1] == 0) and np.all(np.isneginf(lse[1]))
    assert np.all(np.isfinite(out[0])) and np.all(np.isfinite(lse[0]))


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 33, 2, 128, seed=5))
    before = t_attn.LAUNCHES
    out, lse = t_attn.flash_attention_fwd(q, k, v, return_lse=True)
    ref, ref_lse = t_attn.attention_ref(q, k, v, return_lse=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    assert t_attn.LAUNCHES == before      # the count is of kernel launches


def test_attention_dispatcher_takes_key_padding_masks_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 12, 2, 16, seed=6))
    kv_valid = torch.arange(12)[None, :] < torch.tensor([[7], [12]])
    out = t_layers.attention(q, k, v, mask=kv_valid[:, None, None, :])
    torch.testing.assert_close(out, t_attn.attention_ref(q, k, v, kv_valid))
    with pytest.raises(ValueError, match='key-padding'):
        t_layers.attention(q, k, v, mask=torch.ones(2, 1, 12, 12, dtype=bool))


@pytest.mark.parametrize('lengths', [(0, 12), (0, 0), (5, 12)])
def test_layers_attention_matches_jax_attention_with_a_keyless_row(lengths):
    """The model's ``attention()`` against the JAX ``attention`` (XLA on the
    CPU) with a key-padding mask, rows with no valid key included: there
    both give the mean of v over all keys. fp32 on both sides, rtol 2e-5,
    atol 2e-6 as above."""
    q, k, v = _qkv(2, 12, 2, 16, seed=7)
    kv_valid = np.arange(12)[None, :] < np.asarray(lengths)[:, None]
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask=jnp.asarray(kv_valid)[:, None, None, :])
    got = t_layers.attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask=torch.from_numpy(kv_valid)[:, None, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)
    for row in np.flatnonzero(~kv_valid.any(1)):
        np.testing.assert_allclose(got.numpy()[row],
                                   np.broadcast_to(v[row].mean(0), (12, 2, 16)),
                                   rtol=1e-6, atol=1e-6)


def _bf16(shape, **kw):
    return torch.zeros(shape, dtype=torch.bfloat16, **kw)


@pytest.mark.parametrize('bad,match', [
    (dict(q=torch.zeros(1, 64, 2, 128)), 'bfloat16'),
    (dict(q=_bf16((1, 64, 2, 64)), k=_bf16((1, 64, 2, 64)),
          v=_bf16((1, 64, 2, 64))), r'\(B, S, H, 128\)'),
    (dict(k=_bf16((1, 32, 2, 128))), 'shape'),
    (dict(v=_bf16((1, 64, 2, 256))[..., ::2]), 'contiguous last dim'),
    (dict(q=_bf16((1, 64, 2, 132))[..., :128]), 'aligned'),
    (dict(kv_valid=torch.ones(1, 63, dtype=torch.bool)), 'kv_valid'),
    (dict(kv_valid=torch.ones(1, 64, dtype=torch.float32)), 'bool or uint8'),
])
def test_kernel_argument_checks(bad, match):
    """What the kernel does not take is refused before any launch (the
    checks read metadata only, so they run here on CPU tensors)."""
    args = dict(q=_bf16((1, 64, 2, 128)), k=_bf16((1, 64, 2, 128)),
                v=_bf16((1, 64, 2, 128)), kv_valid=None)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        t_attn._check_cuda_args(args['q'], args['k'], args['v'],
                                args['kv_valid'])


@pytest.mark.parametrize('name', ['q', 'k', 'v'])
def test_broadcast_views_are_refused(name):
    """A zero stride on a dimension of more than one element (k shared over
    heads by ``expand``, say) is refused before any launch: the kernels'
    TMA maps step through memory by the strides. A dimension of one
    element may have any stride."""
    _build.check_no_broadcast(**{name: _bf16((1, 64, 1, 128)).expand(
        1, 64, 1, 128)})
    with pytest.raises(ValueError, match='broadcast view'):
        _build.check_no_broadcast(**{name: _bf16((1, 64, 1, 128)).expand(
            1, 64, 2, 128)})


def test_launch_error_names_a_refused_tensor_map():
    """An entry point's code for a TMA map the driver refused names the
    tensor and the CUresult; any other code is CUDA's own error string."""
    class Lib:
        @staticmethod
        def arcflow_cuda_error_string(code):
            return f'cuda error {code}'.encode()

    err = _build._TMA_REFUSED + (4 << 12) + 1
    assert _build.launch_error(Lib, err, ('q', 'k', 'v', 'o', 'dout')) == \
        'the driver refused the TMA map of dout (CUresult 1)'
    assert _build.launch_error(Lib, 700, ('q',)) == 'cuda error 700'
