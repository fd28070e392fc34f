"""The Hopper attention backward kernels against their plain version, on the
card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). This file imports no JAX, so it runs where only the port is
installed: ``python -m pytest --noconftest -q
tests/test_torch_attention_bwd_cuda.py`` (``--noconftest`` because
tests/conftest.py sets up JAX).

Tolerance: relative L2 of each gradient within 2e-2 of the fp32 plain
version on the same bf16 inputs, O and LSE. The kernels round P and dS to
bf16 (8 significant bits) before their products and write bf16 gradients, so
each gradient carries a few bf16 ulps of noise; a layout, mask or scale
error moves it by O(1).
"""

import pytest
import torch

from arcflow_tpu_torch.ops import attention as t_attn

REL_L2 = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _rel(a, b):
    b = b.float()
    return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()


def _check(g, b, s, h, lengths=None, strided=False, strided_do=False):
    if strided:        # q, k, v as views with a head stride of 2 * D
        wide = torch.randn(3, b, s, h, 256, generator=g, device='cuda',
                           dtype=torch.bfloat16)
        q, k, v = (wide[i, ..., :128] for i in range(3))
    else:
        q, k, v = (torch.randn(b, s, h, 128, generator=g, device='cuda',
                               dtype=torch.bfloat16) for _ in range(3))
    kv_valid = None
    if lengths is not None:
        kv_valid = torch.arange(s, device='cuda')[None, :] < torch.tensor(
            lengths, device='cuda')[:, None]
    o, lse = t_attn.flash_attention_fwd(q, k, v, kv_valid, return_lse=True)
    do = torch.randn(b, s, h, 128, generator=g, device='cuda',
                     dtype=torch.bfloat16)
    if strided_do:     # dO as a view with a head stride of 2 * D
        do = torch.cat([do, torch.zeros_like(do)], dim=-1)[..., :128]
        assert t_attn._kernel_dout(do) is do     # the kernel reads the view
    before = t_attn.BWD_LAUNCHES
    got = t_attn.flash_attention_bwd(q, k, v, o, do, lse, kv_valid)
    torch.cuda.synchronize()
    assert t_attn.BWD_LAUNCHES == before + 1
    want = t_attn.attention_bwd_ref(q, k, v, o, do, lse, kv_valid)
    for name, x, y in zip(('dq', 'dk', 'dv'), got, want):
        assert x.dtype == torch.bfloat16 and x.shape == q.shape
        assert torch.isfinite(x).all(), name
        assert _rel(x, y) <= REL_L2, (name, _rel(x, y))
    return got, kv_valid


@pytest.mark.cuda
@pytest.mark.parametrize('b,s,h,lengths', [(1, 4608, 24, None),
                                           (2, 777, 3, None),
                                           (2, 1000, 4, (900, 1000)),
                                           (1, 2, 1, None),
                                           (3, 65, 2, (2, 65, 33))])
def test_backward_matches_plain_version_on_cuda(cuda, b, s, h, lengths):
    """FLUX shape, ragged S, key padding, two keys, one key past a tile.
    (With a single valid key a row's dq is exactly 0 in fp32 and only
    rounding noise in the kernel, so relative L2 says nothing there.)"""
    _check(cuda, b, s, h, lengths)


@pytest.mark.cuda
def test_backward_padded_keys_and_empty_rows_get_zero(cuda):
    """Padded keys get dk = dv = 0; a batch row with no valid key gets
    dq = dk = dv = 0."""
    (dq, dk, dv), kv_valid = _check(cuda, 2, 300, 3, lengths=(0, 250))
    assert not dq[0].any() and not dk[0].any() and not dv[0].any()
    assert not dk[1, 250:].any() and not dv[1, 250:].any()
    assert dq[1].abs().sum() > 0


@pytest.mark.cuda
def test_backward_reads_strided_inputs(cuda):
    _check(cuda, 2, 300, 3, lengths=(250, 300), strided=True)


@pytest.mark.cuda
def test_backward_is_deterministic(cuda):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v, do = (torch.randn(1, 500, 2, 128, generator=cuda, device='cuda',
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = t_attn.flash_attention_fwd(q, k, v, return_lse=True)
    a = t_attn.flash_attention_bwd(q, k, v, o, do, lse)
    b = t_attn.flash_attention_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_autograd_function_launches_both_kernels(cuda):
    """The Function's backward takes a non-contiguous dO (a transposed
    view) and matches autograd through the plain forward."""
    q, k, v = (torch.randn(1, 200, 2, 128, generator=cuda, device='cuda',
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    do = torch.randn(1, 2, 200, 128, generator=cuda, device='cuda',
                     dtype=torch.bfloat16).transpose(1, 2)
    fwd, bwd = t_attn.LAUNCHES, t_attn.BWD_LAUNCHES
    out = t_attn.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (t_attn.LAUNCHES, t_attn.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    ref = t_attn.attention_ref(*(t.float() for t in (q, k, v)))
    want = torch.autograd.grad(ref, (q, k, v), do.float())
    for x, y in zip(got, want):
        assert _rel(x, y) <= REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize('b,s,h,lengths', [(1, 127, 2, None),
                                           (1, 128, 2, None),
                                           (1, 129, 2, None),
                                           (1, 4609, 2, None),
                                           (3, 200, 48, None),
                                           (1, 300, 1, None),
                                           (2, 300, 3, (195, 300)),
                                           (1, 1000, 2, (900,)),
                                           (1, 8320, 1, None)])
def test_backward_tile_edges(cuda, b, s, h, lengths):
    """The 128-key and 64-query tiles and the ordered dQ sum: S one short
    of, at and one past a key tile and past 36 key tiles; more (batch, head)
    pairs than the card has SMs and a single one; a key mask that ends
    inside a tile; 65 key tiles, walked from staggered starts."""
    _check(cuda, b, s, h, lengths)


@pytest.mark.cuda
def test_backward_reads_strided_inputs_and_grad(cuda):
    """q, k, v and dO all as views with a head stride of 2 * D."""
    _check(cuda, 2, 300, 3, lengths=(250, 300), strided=True,
           strided_do=True)


@pytest.mark.cuda
def test_backward_past_the_cards_resident_ctas(cuda):
    """One key tile more per (batch, head) than the card holds backward
    CTAs at once (one per SM: 231 KB of shared memory each): no staggered
    starts, the dQ partials summed in key-tile order."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _check(cuda, 1, (sms + 1) * 128 - 5, 1)

@pytest.mark.cuda
def test_backward_takes_the_broadcast_grad_of_a_sum(cuda):
    """``out.sum()``'s backward hands the Function a broadcast dO (zero
    strides), which the wrapper copies; the gradients match autograd
    through the plain forward."""
    q, k, v = (torch.randn(1, 300, 2, 128, generator=cuda, device='cuda',
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    got = torch.autograd.grad(t_attn.flash_attention(q, k, v).sum(),
                              (q, k, v))
    ref = t_attn.attention_ref(*(t.float() for t in (q, k, v)))
    want = torch.autograd.grad(ref.float().sum(), (q, k, v))
    for x, y in zip(got, want):
        assert torch.isfinite(x).all() and _rel(x, y) <= REL_L2


@pytest.mark.cuda
def test_broadcast_inputs_are_refused(cuda):
    """k shared over heads by ``expand`` (a zero head stride) is refused
    with a clear error by both wrappers, before any launch."""
    q, v, do = (torch.randn(1, 200, 2, 128, generator=cuda, device='cuda',
                            dtype=torch.bfloat16) for _ in range(3))
    k = torch.randn(1, 200, 1, 128, generator=cuda, device='cuda',
                    dtype=torch.bfloat16).expand(1, 200, 2, 128)
    o, lse = t_attn.flash_attention_fwd(q, q, v, return_lse=True)
    with pytest.raises(ValueError, match='broadcast view'):
        t_attn.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match='broadcast view'):
        t_attn.flash_attention_bwd(q, k, v, o, do, lse)
