"""Port parity: the attention backward's plain version
(arcflow_tpu_torch.ops.attention.attention_bwd_ref) and the autograd
Function that carries it, against autograd and against the JAX package.

On the CPU the Function runs ``attention_ref`` forward and
``attention_bwd_ref`` backward; these tests hold that pair against
``torch.autograd`` through ``attention_ref``, the model's
``layers.attention`` (the Function plus its keyless-row rule) against
``jax.vjp`` of ``arcflow_tpu.models.layers.attention`` (XLA attention on
the CPU), and the Function against the JAX package's flash kernel with its
dq/dkv backward kernels (``_flash_call``), run in Pallas interpret mode as
tests/test_flash_attention.py runs the forward. The CUDA kernels run only
on a card: tests/test_torch_attention_bwd_cuda.py, which imports no JAX.

Tolerances: in fp32 against fp32, rtol 1e-4 and atol 1e-5 cover sums in
another order over at most 256 keys; against the interpreted Pallas kernel
atol 2e-3, as tests/test_flash_attention.py holds its forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcflow_tpu.models.layers import _flash_call
from arcflow_tpu.models.layers import attention as j_attention
from arcflow_tpu_torch.models import layers as t_layers
from arcflow_tpu_torch.ops import attention as t_attn

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]                      # q, k, v, dO


def _lengths_mask(s, lengths):
    return np.arange(s)[None, :] < np.asarray(lengths)[:, None]


def _layers_grads(q, k, v, do, kv_valid=None):
    """(dq, dk, dv) of the model's ``attention()`` on CPU tensors."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    mask = None if kv_valid is None \
        else torch.from_numpy(kv_valid)[:, None, None, :]
    out = t_layers.attention(q, k, v, mask=mask)
    return [g.numpy() for g in torch.autograd.grad(out, (q, k, v),
                                                   torch.from_numpy(do))]


def _port_grads(q, k, v, do, kv_valid=None):
    """(dq, dk, dv) of the Function on CPU tensors, as numpy."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    m = None if kv_valid is None else torch.from_numpy(kv_valid)
    out = t_attn.flash_attention(q, k, v, m)
    return [g.numpy() for g in torch.autograd.grad(out, (q, k, v),
                                                   torch.from_numpy(do))]


@pytest.mark.parametrize('s,d,lengths', [(77, 16, None), (33, 128, (20, 33)),
                                         (50, 16, (0, 50))])
def test_bwd_ref_matches_autograd_through_the_forward_ref(s, d, lengths):
    """The formulas against autograd, in float64 so only the formulas can
    differ; a batch row with no valid key included."""
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in _inputs(2, s, 3, d, seed=s))
    kv_valid = None if lengths is None \
        else torch.from_numpy(_lengths_mask(s, lengths))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = t_attn.attention_ref(*leaves, kv_valid, return_lse=True)
    want = torch.autograd.grad(out, leaves, do)
    got = t_attn.attention_bwd_ref(q, k, v, out.detach(), do, lse.detach(),
                                   kv_valid)
    for x, y in zip(got, want):
        assert x.dtype == torch.float64
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('s', [77, 256])
@pytest.mark.parametrize('d', [16, 128])
@pytest.mark.parametrize('masked', [False, True])
def test_grads_match_jax_vjp_of_attention(s, d, masked):
    """The port's ``layers.attention`` against jax.vjp of the JAX
    ``attention`` (XLA on the CPU) with a key mask, every row compared. The
    batch row with no valid key attends uniformly to all keys in both: dq =
    dk = 0 from it and each key's dv = sum_q dO_q / S; padded keys of the
    valid row get dk = dv = 0."""
    q, k, v, do = _inputs(2, s, 2, d, seed=s + d)
    kv_valid = _lengths_mask(s, (s - 17, 0)) if masked else None
    mask = None if kv_valid is None else jnp.asarray(kv_valid)[:, None, None]
    _, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, mask=mask),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = _layers_grads(q, k, v, do, kv_valid)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, **TOL)
    if masked:
        assert not got[0][1].any() and not got[1][1].any()
        np.testing.assert_allclose(
            got[2][1], np.broadcast_to(do[1].sum(0) / s, (s, 2, d)), **TOL)
        assert not got[1][0, s - 17:].any() and not got[2][0, s - 17:].any()


def test_function_gives_a_keyless_row_zero_output_and_gradients():
    """The ops-level Function keeps the kernels' contract for a row with no
    valid key: O = 0 and zero dq, dk, dv (``layers.attention`` replaces that
    row's output, see above)."""
    q, k, v, do = _inputs(2, 30, 2, 16, seed=8)
    kv_valid = _lengths_mask(30, (30, 0))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = t_attn.flash_attention(tq, tk, tv, torch.from_numpy(kv_valid))
    assert not out[1].detach().any() and out[0].detach().abs().sum() > 0
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert all(not g[1].any() for g in got)


@pytest.mark.parametrize('masked', [False, True])
def test_grads_match_the_pallas_flash_backward(masked):
    """The TPU kernels this port's backward replaces: ``_flash_call``'s
    custom VJP (dq and dkv Pallas kernels) in interpret mode."""
    q, k, v, do = _inputs(1, 512, 2, 128, seed=9)
    kv_valid = _lengths_mask(512, (400,)) if masked else None
    kv = None if kv_valid is None else jnp.asarray(kv_valid)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: _flash_call(a, b, c, kv_valid=kv),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = _port_grads(q, k, v, do, kv_valid)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, atol=2e-3)


def test_function_on_cpu_is_the_plain_pair():
    """On CPU tensors the Function's forward is ``attention_ref`` and its
    backward ``attention_bwd_ref``, bit for bit, and no kernel is counted."""
    q, k, v, do = _inputs(2, 40, 2, 16, seed=5)
    kv_valid = _lengths_mask(40, (30, 40))
    fwd, bwd = t_attn.LAUNCHES, t_attn.BWD_LAUNCHES
    got = _port_grads(q, k, v, do, kv_valid)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    m = torch.from_numpy(kv_valid)
    out, lse = t_attn.attention_ref(tq, tk, tv, m, return_lse=True)
    want = t_attn.attention_bwd_ref(tq, tk, tv, out, tdo, lse, m)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy())
    assert (t_attn.LAUNCHES, t_attn.BWD_LAUNCHES) == (fwd, bwd)


def test_layers_attention_is_differentiable_with_a_key_padding_mask():
    """The model's ``attention()`` goes through the Function: gradients
    reach q, k and v, and the mask gets none."""
    q, k, v, do = (torch.from_numpy(x).requires_grad_()
                   for x in _inputs(2, 12, 2, 16, seed=6))
    mask = torch.from_numpy(_lengths_mask(12, (7, 12)))[:, None, None]
    out = t_layers.attention(q, k, v, mask=mask)
    out.backward(do.detach())
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))
    assert not k.grad[0, 7:].any() and not v.grad[0, 7:].any()


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize('bad,match', [
    (dict(dout=_bf16((1, 64, 2, 128))[:, :32]), 'shape'),
    (dict(o=torch.zeros(1, 64, 2, 128)), 'bfloat16'),
    (dict(dout=_bf16((1, 64, 2, 256))[..., ::2]), 'contiguous last dim'),
])
def test_backward_argument_checks(bad, match):
    """o and dO are held to q's rules before any launch (metadata only, so
    the checks run here on CPU tensors)."""
    args = dict(o=_bf16((1, 64, 2, 128)), dout=_bf16((1, 64, 2, 128)))
    args.update(bad)
    q = _bf16((1, 64, 2, 128))
    with pytest.raises(ValueError, match=match):
        t_attn._check_cuda_args(q, q, q, None, **args)


@pytest.mark.parametrize('make,copied', [
    (lambda: _bf16((1, 2, 64, 128)).transpose(1, 2), False),
    (lambda: _bf16((1, 64, 2, 256))[..., :128], False),
    (lambda: _bf16((1, 1, 1, 1)).expand(1, 64, 2, 128), True),
    (lambda: _bf16((1, 64, 2, 256))[..., ::2], True),
    (lambda: _bf16((1, 64, 2, 132))[..., :128], True),
])
def test_kernel_dout_copies_only_what_the_kernel_cannot_read(make, copied):
    """The backward wrapper hands dO to the kernel as it lies where its TMA
    map reads it (a transposed view, a head stride of 2 D) and copies it
    only where not (the broadcast a sum's backward gives, a strided last
    dim, rows off 16 bytes); the values stay the same."""
    do = make()
    got = t_attn._kernel_dout(do)
    assert (got is not do) == copied
    assert torch.equal(got, do)
    t_attn._check_cuda_args(got, got, got, None, dout=got)
