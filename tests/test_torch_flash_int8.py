"""Port parity for the int8-QK^T flash attention (K7): the plain version
``flash_attention_int8_ref`` and the quantization ``rowwise_int8`` of
``arcflow_tpu_torch/ops/flash_int8.py`` against the JAX package's
``arcflow_tpu/ops/flash_int8.py``.

The JAX kernel runs as its own tests run it on the CPU, in interpret mode,
at their shape (B2 S512 H3 D128, blocks of 256). Inputs come from numpy
seeds. Tolerances: ``rowwise_int8`` bitwise; the plain version against the
formula of tests/test_flash_int8.py:_reference (the same int8 rows,
dequantized, an fp32 softmax, V through bf16) atol 1e-5, since both compute
the same scores up to fp32 rounding of the rescale; against the Pallas
kernel the JAX test's own 2e-2 per element plus a relative L2 of 1e-2: the
kernel rounds P to bf16 (2^-9 relative) before P.V and the plain version
does not, which reads a few 1e-3 by relative L2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.ops import flash_int8 as j_fi8
from arcflow_tpu_torch.ops import attention as t_attn
from arcflow_tpu_torch.ops import flash_int8 as t_fi8

B, S, H, D = 2, 512, 3, 128
INTERPRET_BLOCKS = dict(block_q=256, block_k=256, interpret=True)


def _qkv(seed=0, shape=(B, S, H, D)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _valid():
    """Row 0 keeps its first half, row 1 all but the last 64 keys (the
    JAX test's mask)."""
    return np.arange(S)[None, :] < np.array([[S // 2], [S - 64]])


def _jax_reference(q, k, v, kv_valid=None):
    """tests/test_flash_int8.py:_reference, on numpy inputs."""
    q, k, v = (jnp.asarray(x) for x in (q, k, v))
    qq, qs = j_fi8.rowwise_int8(q.transpose(0, 2, 1, 3))
    kq, kss = j_fi8.rowwise_int8(k.transpose(0, 2, 1, 3))
    qd = qq.astype(jnp.float32) * qs
    kd = kq.astype(jnp.float32) * kss
    s = jnp.einsum('bhqd,bhkd->bhqk', qd, kd) / (q.shape[-1] ** 0.5)
    if kv_valid is not None:
        s = jnp.where(jnp.asarray(kv_valid)[:, None, None, :], s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    vb = v.transpose(0, 2, 1, 3).astype(jnp.bfloat16).astype(jnp.float32)
    return np.asarray(jnp.einsum('bhqk,bhkd->bhqd', p, vb)
                      .transpose(0, 2, 1, 3))


def _port(q, k, v, kv_valid=None):
    return t_fi8.flash_attention_int8_ref(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if kv_valid is None else torch.from_numpy(kv_valid)).numpy()


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_rowwise_int8_bitwise_equals_jax():
    x = _qkv(1, (2, 37, 3, D))[0] * 3.0
    x[0, 5, 1] = 0.0                       # an all-zero row: the 1e-6 floor
    x[1, 2, 0, :4] = [0.5, -0.5, 1.5, 127.0 / 254.0]   # halves round to even
    jq, js = j_fi8.rowwise_int8(jnp.asarray(x))
    tq, ts = t_fi8.rowwise_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_qk_gives_the_kernel_layout():
    q, k, _ = (torch.from_numpy(x) for x in _qkv(2, (2, 40, 3, D)))
    qq, qs, kq, ks = t_fi8.quantize_qk(q, k)
    assert qq.shape == kq.shape == (2, 40, 3, D) and qq.is_contiguous()
    assert qs.shape == ks.shape == (2, 3, 40) and qs.is_contiguous()
    ref_q, ref_s = t_fi8.rowwise_int8(q)
    assert torch.equal(qq, ref_q)
    assert torch.equal(qs, ref_s[..., 0].transpose(1, 2))


@pytest.mark.parametrize('masked', [False, True])
def test_plain_version_matches_the_reference_formula(masked):
    q, k, v = _qkv(0)
    valid = _valid() if masked else None
    np.testing.assert_allclose(_port(q, k, v, valid),
                               _jax_reference(q, k, v, valid), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize('masked', [False, True])
def test_plain_version_matches_the_pallas_kernel(masked):
    q, k, v = _qkv(0)
    valid = _valid() if masked else None
    want = np.asarray(j_fi8.flash_attention_int8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_valid=None if valid is None else jnp.asarray(valid, jnp.int32),
        **INTERPRET_BLOCKS), np.float32)
    got = _port(q, k, v, valid)
    assert np.abs(got - want).max() < 2e-2
    assert _rel_l2(got, want) < 1e-2


def test_plain_version_scores_are_the_exact_int8_dot():
    """The scores are the integer dot of the int8 rows times s_q s_k /
    sqrt(D), with the integer part exact (fp64)."""
    q, k, _ = (torch.from_numpy(x) for x in _qkv(3, (1, 64, 2, D)))
    qq, qs, kq, ks = t_fi8.quantize_qk(q, k)
    got = t_fi8.scores_ref(qq, qs, kq, ks, 1.0 / math.sqrt(D))
    dot = np.einsum('bqhd,bkhd->bhqk', qq.numpy().astype(np.int64),
                    kq.numpy().astype(np.int64))
    want = dot * (qs.numpy()[..., None] / math.sqrt(D)) * \
        ks.numpy()[:, :, None, :]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_keyless_row_gets_the_mean_of_v_as_in_jax():
    """A batch row whose every key is masked scores -1e30 everywhere, so it
    attends uniformly: the mean of v (through bf16) on every query, in the
    port as in the JAX kernel (not the O = 0 of the other kernels)."""
    q, k, v = _qkv(4)
    valid = np.ones((B, S), bool)
    valid[0] = False
    got = _port(q, k, v, valid)
    v_bf16 = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(
        got[0], np.broadcast_to(v_bf16[0].mean(0), (S, H, D)), rtol=0,
        atol=1e-6)
    want = np.asarray(j_fi8.flash_attention_int8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_valid=jnp.asarray(valid, jnp.int32), **INTERPRET_BLOCKS))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, _jax_reference(q, k, v, valid), rtol=0,
                               atol=1e-5)


def test_close_to_full_precision_attention():
    """tests/test_flash_int8.py's property on the port: cosine above 0.999
    against fp32 attention."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(0))
    out = t_fi8.flash_attention_int8_ref(q, k, v).double().flatten()
    full = t_attn.attention_ref(q, k, v).double().flatten()
    assert (out @ full / (out.norm() * full.norm())).item() > 0.999


def test_cpu_wrapper_takes_the_plain_version():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(5, (1, 100, 2, D)))
    valid = torch.arange(100)[None] < 77
    before = t_fi8.LAUNCHES
    got = t_fi8.flash_attention_int8(q, k, v, valid)
    assert t_fi8.LAUNCHES == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, t_fi8.flash_attention_int8_ref(q, k, v, valid))


def test_other_devices_are_refused():
    q = torch.zeros(1, 64, 2, D, device='meta')
    with pytest.raises(ValueError, match='no int8 attention kernel'):
        t_fi8.flash_attention_int8(q, q, q)


def _i8(shape=(1, 64, 2, D)):
    return torch.zeros(shape, dtype=torch.int8)


def _scales(shape=(1, 2, 64)):
    return torch.ones(shape, dtype=torch.float32)


@pytest.mark.parametrize('bad,match', [
    (dict(q=torch.zeros(1, 64, 2, D, dtype=torch.float16)), 'one of'),
    (dict(k=torch.zeros(1, 64, 2, D, dtype=torch.bfloat16)), "q's dtype"),
    (dict(v=torch.zeros(1, 64, 2, 256)[..., ::2]), 'contiguous last dim'),
    (dict(q=torch.zeros(1, 64, 2, 64), k=torch.zeros(1, 64, 2, 64),
          v=torch.zeros(1, 64, 2, 64)), r'\(B, S, H, 128\)'),
    (dict(kv_valid=torch.ones(1, 63, dtype=torch.bool)), 'kv_valid'),
])
def test_wrapper_argument_checks(bad, match):
    """The wrapper's checks on a CUDA tensor (``ops/attention.py``'s, with
    fp32 allowed beside bf16) read metadata only, so they run here."""
    args = dict(q=torch.zeros(1, 64, 2, D), k=torch.zeros(1, 64, 2, D),
                v=torch.zeros(1, 64, 2, D), kv_valid=None)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        t_attn._check_cuda_args(args['q'], args['k'], args['v'],
                                args['kv_valid'],
                                dtypes=(torch.bfloat16, torch.float32))


@pytest.mark.parametrize('bad,match', [
    (dict(qq=torch.zeros(1, 64, 2, D)), 'qq must be torch.int8'),
    (dict(kq=_i8((1, 32, 2, D))), 'kq must be'),
    (dict(v=torch.zeros(1, 64, 2, D)), 'v must be torch.bfloat16'),
    (dict(kq=torch.zeros(1, 64, 2, D + 8, dtype=torch.int8)[..., :D]),
     'aligned'),
    (dict(qs=_scales((1, 64, 2))), 'qs must be'),
    (dict(ks=_scales().transpose(1, 2).contiguous().transpose(1, 2)),
     'ks must be'),
])
def test_launch_refuses_operands_it_does_not_take(bad, match):
    """``launch`` checks the prepared operands before it loads the
    library."""
    args = dict(qq=_i8(), qs=_scales(), kq=_i8(), ks=_scales(),
                v=torch.zeros(1, 64, 2, D, dtype=torch.bfloat16))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        t_fi8.launch(args['qq'], args['qs'], args['kq'], args['ks'],
                     args['v'], None, 1.0, torch.bfloat16)


def test_rowwise_int8_scale_is_the_ieee_quotient():
    """scale = max(absmax, 1e-6) / 127 as one IEEE division in fp32 (numpy's
    float32 division), not a product with 1/127: the quantization kernel
    divides so, and so does JAX."""
    x = _qkv(6, (3, 50, 4, D))[0] * np.exp(
        3 * np.random.default_rng(7).standard_normal((3, 50, 4, 1)))
    x = x.astype(np.float32)
    _, scale = t_fi8.rowwise_int8(torch.from_numpy(x))
    want = np.maximum(np.abs(x).max(-1, keepdims=True),
                      np.float32(1e-6)) / np.float32(127)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(scale.numpy(), want)


# the attention kernel's key tile (csrc/flash_int8.cu:kBlockN)
KEY_TILE = 128


@pytest.mark.parametrize('b,s,h', [(1, 4608, 24), (2, 1000, 3), (3, 77, 2),
                                   (1, 1, 1), (1, 129, 1)])
def test_key_scale_rows_cover_every_key(b, s, h):
    """The rows the kernel's 2-D TMA map reads: a pitch that TMA can step (a
    multiple of 4 values), every key k < S of every (b, h) at column k of
    its row, zeros from S to the pitch, and each 128-key box starting inside
    its row; no copy when S is a multiple of 4."""
    ks = torch.rand(b, h, s) + 0.5
    rows, pitch = t_fi8.key_scale_rows(ks)
    assert pitch % 4 == 0 and s <= pitch < s + 4
    assert rows.shape == (b * h, pitch) and rows.is_contiguous()
    assert torch.equal(rows[:, :s], ks.reshape(b * h, s))
    assert not rows[:, s:].any()
    assert (rows.data_ptr() == ks.data_ptr()) == (s % 4 == 0)
    starts = KEY_TILE * torch.arange(-(-s // KEY_TILE))
    assert starts.max().item() < s
    boxes = torch.nn.functional.pad(rows[:, :s], (0, KEY_TILE))[
        :, starts[:, None] + torch.arange(KEY_TILE)]
    keys = torch.arange(s)
    assert torch.equal(boxes[:, keys // KEY_TILE, keys % KEY_TILE],
                       ks.reshape(b * h, s))


def test_quantize_qk_refuses_other_devices():
    q = torch.zeros(1, 64, 2, D, device='meta')
    with pytest.raises(ValueError, match='no int8 quantization kernel'):
        t_fi8.quantize_qk(q, q)


def test_launch_refuses_misaligned_key_scales():
    """The key scales are read by a TMA map, whose base must be 16-byte
    aligned."""
    ks = torch.ones(1 * 2 * 64 + 1)[1:].reshape(1, 2, 64)
    assert ks.is_contiguous() and ks.data_ptr() % 16
    with pytest.raises(ValueError, match='ks needs a 16-byte aligned'):
        t_fi8.launch(_i8(), _scales(), _i8(), ks,
                     torch.zeros(1, 64, 2, D, dtype=torch.bfloat16), None,
                     1.0, torch.bfloat16)
