"""The Hopper attention kernel against its plain version, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernel has no CPU
mode). This file imports no JAX, so it runs where only the port is
installed: ``python -m pytest --noconftest -q tests/test_torch_attention_cuda.py``
(``--noconftest`` because tests/conftest.py sets up JAX).

Tolerances, bf16 kernel vs fp32 plain version: O within 2e-2, since the
kernel rounds P to bf16 before P.V and O to bf16 at the end (about three
significant digits each, on O(1) values); LSE within 1e-3 (fp32 softmax
statistics of scores from bf16 products, summed in another order).
"""

import pytest
import torch

from arcflow_tpu_torch.ops import attention as t_attn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _qkv(g, b, s, h):
    return [torch.randn(b, s, h, 128, generator=g, device='cuda',
                        dtype=torch.bfloat16) for _ in range(3)]


def _check(q, k, v, kv_valid=None):
    before = t_attn.LAUNCHES
    out, lse = t_attn.flash_attention_fwd(q, k, v, kv_valid, return_lse=True)
    torch.cuda.synchronize()
    assert t_attn.LAUNCHES == before + 1
    ref, ref_lse = t_attn.attention_ref(q, k, v, kv_valid, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    return out, lse


@pytest.mark.cuda
@pytest.mark.parametrize('b,s,h,pad', [(1, 4608, 24, False),
                                       (2, 1000, 4, False),
                                       (2, 777, 3, True),
                                       (1, 1, 1, False),
                                       (3, 65, 2, True)])
def test_kernel_matches_plain_version_on_cuda(cuda, b, s, h, pad):
    """FLUX shape, ragged S, key padding, one key, one key past a tile."""
    q, k, v = _qkv(cuda, b, s, h)
    kv_valid = None
    if pad:
        lengths = torch.tensor([max(s - 100, 1)] + [s] * (b - 1),
                               device='cuda')
        kv_valid = torch.arange(s, device='cuda')[None, :] < lengths[:, None]
    _check(q, k, v, kv_valid)


@pytest.mark.cuda
def test_kernel_reads_strided_inputs_and_uint8_masks(cuda):
    """q/k/v as views with a head stride of 2*D (no copy is made), and the
    mask as uint8 instead of bool."""
    b, s, h = 2, 300, 3
    wide = torch.randn(3, b, s, h, 256, generator=cuda, device='cuda',
                       dtype=torch.bfloat16)
    q, k, v = (wide[i, ..., :128] for i in range(3))
    assert not q.is_contiguous()
    kv_valid = (torch.arange(s, device='cuda')[None, :] < torch.tensor(
        [[250], [300]], device='cuda')).to(torch.uint8)
    _check(q, k, v, kv_valid)


@pytest.mark.cuda
def test_kernel_row_without_valid_key_is_zero(cuda):
    q, k, v = _qkv(cuda, 2, 70, 2)
    kv_valid = torch.ones(2, 70, dtype=torch.bool, device='cuda')
    kv_valid[0] = False
    out, lse = _check(q, k, v, kv_valid)
    assert torch.all(out[0] == 0) and torch.all(torch.isneginf(lse[0]))


@pytest.mark.cuda
@pytest.mark.parametrize('b,s,h,lengths', [(1, 127, 2, None),
                                           (1, 128, 2, None),
                                           (1, 129, 2, None),
                                           (1, 4609, 2, None),
                                           (3, 200, 48, None),
                                           (1, 300, 1, None),
                                           (2, 300, 3, (195, 300)),
                                           (1, 1000, 2, (900,))])
def test_kernel_tile_edges(cuda, b, s, h, lengths):
    """The 128-row query and key tiles: S one short of, at and one past a
    tile and past 36 tiles; more (batch, head) pairs than the card has SMs
    and a single one; a key mask that ends inside a tile."""
    q, k, v = _qkv(cuda, b, s, h)
    kv_valid = None
    if lengths is not None:
        kv_valid = torch.arange(s, device='cuda')[None, :] < torch.tensor(
            lengths, device='cuda')[:, None]
    _check(q, k, v, kv_valid)


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    """No split over keys: two launches on the same inputs give the same
    bits."""
    q, k, v = _qkv(cuda, 1, 1000, 4)
    kv_valid = torch.arange(1000, device='cuda')[None, :] < 900
    a = t_attn.flash_attention_fwd(q, k, v, kv_valid, return_lse=True)
    b = t_attn.flash_attention_fwd(q, k, v, kv_valid, return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
