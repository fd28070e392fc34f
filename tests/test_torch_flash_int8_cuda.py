"""The Hopper int8-QK^T attention kernel (K7) against its plain version, on
the card.

Marked ``cuda``: they skip without a CUDA device (the kernel has no CPU
mode). This file imports no JAX, so it runs where only the port is
installed: ``python -m pytest --noconftest -q
tests/test_torch_flash_int8_cuda.py``.

Limits, kernel against ``flash_attention_int8_ref`` on the same inputs
(``chip_smoke.py``'s K7_ATOL, K7_RTOL, K7_REL_L2): every element within
2e-3 + 2^-7 |ref| and the whole within 1e-2 by relative L2. Both compute
the same exact int8 scores; the kernel rounds P to bf16 (2^-9 relative)
before P.V and its sums run in another order, which reads at most one bf16
ulp of O and a few 1e-3 by relative L2. Two planted faults (the k scales
dropped; int8 key rows 0-7 and 8-15 swapped in one tile, which is what a
wrong accumulator-to-key mapping does) must break both limits. The fused
row quantization (``quantize_qk``) must equal ``rowwise_int8`` bitwise, on
the card and on a CPU copy of its input.
"""

import pytest
import torch

from arcflow_tpu_torch.ops import flash_int8 as fi8

ATOL, RTOL, REL_L2 = 2e-3, 2 ** -7, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _qkv(g, b, s, h, dtype=torch.bfloat16):
    return [torch.randn(b, s, h, 128, generator=g, device='cuda',
                        dtype=dtype) for _ in range(3)]


def _valid(b, s, lengths):
    return torch.arange(s, device='cuda')[None, :] < torch.tensor(
        lengths, device='cuda')[:, None]


def _readings(got, want):
    got, want = got.float(), want.float()
    d = (got - want).abs()
    over = (d - ATOL - RTOL * want.abs()).max().item()
    rel = ((got - want).norm() / want.norm()).item()
    return over, rel


def _check(q, k, v, kv_valid=None):
    before = fi8.LAUNCHES
    out = fi8.flash_attention_int8(q, k, v, kv_valid)
    again = fi8.flash_attention_int8(q, k, v, kv_valid)
    torch.cuda.synchronize()
    assert fi8.LAUNCHES == before + 2
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)                  # bitwise repeatable
    ref = fi8.flash_attention_int8_ref(q, k, v, kv_valid)
    over, rel = _readings(out, ref)
    assert over <= 0 and rel <= REL_L2, (over, rel)
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize('b,s,h,lengths', [
    (1, 4608, 24, None),                     # the FLUX serving shape
    (1, 4608, 24, (4480,)),                  # the Qwen key padding
    (2, 512, 3, None),                       # tests/test_flash_int8.py
    (2, 512, 3, (256, 448)),
    (2, 1000, 4, (900, 1000)),               # ragged S
    (3, 77, 2, (77, 1, 40)),
])
def test_kernel_matches_plain_version(cuda, b, s, h, lengths):
    q, k, v = _qkv(cuda, b, s, h)
    _check(q, k, v, None if lengths is None else _valid(b, s, lengths))


@pytest.mark.cuda
def test_keyless_row_gets_the_mean_of_v(cuda):
    q, k, v = _qkv(cuda, 2, 512, 3)
    valid = _valid(2, 512, (0, 512))
    out, _ = _check(q, k, v, valid)
    mean = v[0].float().mean(0)                      # (H, D)
    torch.testing.assert_close(out[0].float(), mean.expand(512, 3, 128)
                               .to(torch.bfloat16).float(), rtol=0,
                               atol=2 ** -7)


@pytest.mark.cuda
def test_fp32_inputs_give_fp32_output(cuda):
    q, k, v = _qkv(cuda, 2, 256, 2, dtype=torch.float32)
    _check(q, k, v, _valid(2, 256, (200, 256)))


@pytest.mark.cuda
def test_strided_inputs(cuda):
    """(B, S, H, D) read through its strides: a head-major tensor seen as
    (B, S, H, D)."""
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in _qkv(cuda, 1, 320, 4))
    assert not q.is_contiguous()
    _check(q, k, v)


@pytest.mark.cuda
def test_planted_faults_break_both_limits(cuda):
    q, k, v = _qkv(cuda, 2, 512, 3)
    qq, qs, kq, ks = fi8.quantize_qk(q, k)
    sm_scale = 128 ** -0.5
    ref = fi8.flash_attention_int8_ref(q, k, v)
    sound = fi8.launch(qq, qs, kq, ks, v, None, sm_scale, torch.bfloat16)
    over, rel = _readings(sound, ref)
    assert over <= 0 and rel <= REL_L2
    swap = torch.cat([torch.arange(8, 16), torch.arange(8)]).cuda()
    kq_bad = kq.clone()
    kq_bad[:, :16] = kq[:, swap]
    faults = {'k scales dropped': (kq, torch.ones_like(ks)),
              'key rows swapped in one tile': (kq_bad, ks)}
    for name, (k_i8, k_scale) in faults.items():
        bad = fi8.launch(qq, qs, k_i8, k_scale, v, None, sm_scale,
                         torch.bfloat16)
        over, rel = _readings(bad, ref)
        assert over > 0 and rel > REL_L2, (name, over, rel)


@pytest.mark.cuda
def test_launch_refusals_on_the_card(cuda):
    q, k, v = _qkv(cuda, 1, 64, 2)
    with pytest.raises(ValueError, match='one of'):
        fi8.flash_attention_int8(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match='128'):
        fi8.flash_attention_int8(q[..., :64], k[..., :64], v[..., :64])


def _quant_rows(g, b, s, h, dtype):
    """Random rows with the cases the rounding has to get right: a row of
    zeros (the 1e-6 floor), a row whose scale is exactly 1 (absmax 127)
    holding ties at .5 and their negatives (round half to even), and rows
    of every magnitude."""
    x = torch.randn(b, s, h, 128, generator=g, device='cuda') * torch.exp(
        4 * torch.randn(b, s, h, 1, generator=g, device='cuda'))
    x[0, 0, 0] = 0.0
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                        device='cuda')
    x[0, 1, 0, :8] = ties
    x[0, 1, 0, 8:] = 0.25
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,s,h', [(1, 4608, 24), (2, 1000, 3), (1, 77, 2)])
def test_fused_quantization_equals_rowwise_int8_bitwise(cuda, dtype, b, s, h):
    q = _quant_rows(cuda, b, s, h, dtype)
    k = _quant_rows(cuda, b, s, h, dtype).transpose(1, 2).contiguous() \
        .transpose(1, 2)                                 # head-major
    assert not k.is_contiguous()
    before = fi8.QUANT_LAUNCHES
    got = fi8.quantize_qk(q, k)
    torch.cuda.synchronize()
    assert fi8.QUANT_LAUNCHES == before + 1
    on_card = fi8.quantize_qk_ref(q, k)
    on_cpu = fi8.quantize_qk_ref(q.cpu(), k.cpu())
    for name, x, y, z in zip(('qq', 'qs', 'kq', 'ks'), got, on_card,
                             on_cpu):
        assert x.is_contiguous() and x.dtype == y.dtype, name
        assert torch.equal(x, y), name
        assert torch.equal(x.cpu(), z), name
    qq, qs = got[0], got[1]
    floor = torch.tensor(1e-6, dtype=torch.float32) / 127
    assert qs[0, 0, 0].item() == floor.item()
    assert qs[0, 0, 1].item() == 1.0
    assert qq[0, 1, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.cuda
def test_attention_call_launches_each_kernel_once(cuda):
    q, k, v = _qkv(cuda, 1, 300, 2)
    before = fi8.LAUNCHES, fi8.QUANT_LAUNCHES
    fi8.flash_attention_int8(q, k, v)
    fi8.flash_attention_int8_ref(q, k, v)
    assert (fi8.LAUNCHES, fi8.QUANT_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)


@pytest.mark.cuda
def test_key_scales_of_a_ragged_tile_past_the_end(cuda):
    """The last tile of the last head reads its key scales past the end of
    the scale tensor (TMA gives zeros there): a ragged S with one head and
    one batch row, so that tile is the tensor's end, with the scales kept
    at their own allocation."""
    for s in (1, 129, 1000):
        q, k, v = _qkv(cuda, 1, s, 1)
        _check(q, k, v)
