"""The Hopper w4a8 grouped-matmul kernel against its plain version, on the
card.

Marked ``cuda``: they skip without a CUDA device (the kernel has no CPU
mode). This file imports no JAX, so it runs where only the port is
installed: ``python -m pytest --noconftest -q tests/test_torch_w4a8_cuda.py``
(``--noconftest`` because tests/conftest.py sets up JAX).

Tolerance: every per-group partial sum is an integer below 2^24, exact in
int32 in the kernel and in fp32 in the plain version (TF32 off), so the two
differ only in how the fp32 sum over scale groups rounds. Each output is
held within 1e-6 of its own ``sum_k |xq[m, k]| |w[k, n]| scale[k // group,
n]``, a few fp32 ulps of that sum. The fused epilogue (``row_scale``,
``out_dtype``) is the same fp32 product and rounding as scaling and casting
the fp32 output afterwards, so it is held to that bit for bit.
"""

import pytest
import torch

from arcflow_tpu_torch.ops import quant_matmul as qmm
from arcflow_tpu_torch.utils.quantize import pack_int4, unpack_int4

REL_TOL = 1e-6

# (M, K, N) of every int4 layer of the Qwen-Image 20B path: image and text
# streams (4096 and 512 tokens), txt_in, the AdaLN modulations and the
# timestep embedder (one token)
PATH_SHAPES = [(4096, 3072, 3072), (4096, 3072, 12288), (4096, 12288, 3072),
               (512, 3072, 3072), (512, 3072, 12288), (512, 12288, 3072),
               (512, 3584, 3072), (1, 3072, 18432), (1, 256, 3072),
               (1, 3072, 3072)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _case(g, m, k, n, group):
    xq = torch.randint(-127, 128, (m, k), generator=g, device='cuda',
                       dtype=torch.int8)
    q = torch.randint(-8, 8, (k, n), generator=g, device='cuda',
                      dtype=torch.int8)
    scale = 0.01 + 0.05 * torch.rand(k // group, n, generator=g,
                                     device='cuda')
    return xq, q, scale


def _check(xq, q, scale, group):
    packed = pack_int4(q, group)
    before = qmm.LAUNCHES
    out = qmm.w4a8_matmul(xq, packed, scale)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES == before + 1
    ref = qmm.w4a8_matmul_ref(xq, packed, scale)
    w_abs = q.abs().float() * scale.repeat_interleave(group, dim=0)
    bound = REL_TOL * (xq.abs().float() @ w_abs)
    assert out.shape == ref.shape == (xq.shape[0], q.shape[1])
    assert out.dtype == torch.float32
    err = (out - ref).abs()
    assert bool((err <= bound).all()), (err - bound).max().item()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n', PATH_SHAPES)
def test_kernel_matches_plain_version_at_path_shapes(cuda, m, k, n):
    _check(*_case(cuda, m, k, n, 128), 128)


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n,group', [(777, 3072, 3072, 128),
                                         (130, 512, 264, 32),
                                         (3, 320, 136, 64),
                                         (1, 96, 8, 32)])
def test_kernel_ragged_shapes_and_small_groups(cuda, m, k, n, group):
    """M and N off the 128 tile, K off the 128 stage, groups of 32 and 64."""
    _check(*_case(cuda, m, k, n, group), group)


@pytest.mark.cuda
@pytest.mark.parametrize('group', [32, 64, 128])
def test_kernel_extreme_values_are_exact(cuda, group):
    """Nibble -8 and activation -127 everywhere in some columns and rows:
    with scale 1 the output is the exact integer product, which reaches
    +-127 * 8 * K."""
    m, k, n = 70, 4 * group, 24
    xq, q, _ = _case(cuda, m, k, n, group)
    q[:, :5] = -8
    q[:, 5] = 7
    xq[:3] = -127
    out = _check(xq, q, torch.ones(k // group, n, device='cuda'), group)
    want = xq.double() @ q.double()
    assert torch.equal(out.double(), want)
    assert out[0, 0].item() == 127 * 8 * k


@pytest.mark.cuda
def test_pack_round_trips_on_the_card(cuda):
    q = torch.randint(-8, 8, (256, 40), generator=cuda, device='cuda',
                      dtype=torch.int8)
    assert torch.equal(unpack_int4(pack_int4(q, 64), 64), q)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    xq, q, scale = _case(cuda, 4, 256, 16, 128)
    packed = pack_int4(q, 128)
    with pytest.raises(ValueError, match='group size'):
        qmm.w4a8_matmul(xq, packed, scale[:1].contiguous())    # group 256
    with pytest.raises(ValueError, match='multiple of 8'):
        qmm.w4a8_matmul(xq, packed[:, :12].contiguous(),
                        scale[:, :12].contiguous())
    with pytest.raises(ValueError, match='contiguous'):
        qmm.w4a8_matmul(xq.t().contiguous().t(), packed, scale)
    with pytest.raises(ValueError, match='int8'):
        qmm.w4a8_matmul(xq.float(), packed, scale)


@pytest.mark.cuda
@pytest.mark.parametrize('group', [32, 64, 128])
@pytest.mark.parametrize('n', [136, 264])
@pytest.mark.parametrize('m', [1, 3, 130, 511, 513, 777, 4097])
def test_kernel_ragged_m_and_n_at_every_group(cuda, m, n, group):
    """M off the 128-token and the 8-token tiles, N off the 128-column tile
    and off the 16 bytes a TMA row steps in (the wrapper pads N = 136 to
    144), at K = 384 for every group size."""
    _check(*_case(cuda, m, 384, n, group), group)


def _fused_case(g, m, k, n, group):
    xq, q, scale = _case(g, m, k, n, group)
    xs = 0.001 + 0.01 * torch.rand(m, 1, generator=g, device='cuda')
    return xq, pack_int4(q, group), scale, xs


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('m,k,n,group', [
    (m, k, n, 128) for m, k, n in PATH_SHAPES] + [
    (3, 384, 136, 32), (513, 384, 264, 64), (4097, 384, 136, 128)])
def test_fused_epilogue_equals_the_two_step_path_bitwise(cuda, m, k, n,
                                                         group, dtype):
    """``row_scale`` and ``out_dtype`` make the kernel write
    ``(acc * row_scale).to(out_dtype)`` itself: the same fp32 product and
    rounding as the fp32 output scaled and cast afterwards
    (``models/layers.py:_int4_matmul`` before the fusion), bit for bit."""
    xq, packed, scale, xs = _fused_case(cuda, m, k, n, group)
    before = qmm.LAUNCHES
    fused = qmm.w4a8_matmul(xq, packed, scale, row_scale=xs, out_dtype=dtype)
    y = qmm.w4a8_matmul(xq, packed, scale)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES == before + 2
    assert fused.dtype == dtype and fused.shape == (m, n)
    assert torch.equal(fused, (y * xs).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n,group', [(4096, 3072, 3072, 128),
                                         (512, 3072, 12288, 128),
                                         (1, 3072, 18432, 128),
                                         (130, 512, 264, 32)])
def test_two_runs_are_bitwise_equal(cuda, m, k, n, group):
    """No split over groups and no atomics: every output is summed by one
    thread in group order, so a second run gives the same bits."""
    xq, packed, scale, xs = _fused_case(cuda, m, k, n, group)
    assert torch.equal(qmm.w4a8_matmul(xq, packed, scale),
                       qmm.w4a8_matmul(xq, packed, scale))
    assert torch.equal(
        qmm.w4a8_matmul(xq, packed, scale, xs, torch.bfloat16),
        qmm.w4a8_matmul(xq, packed, scale, xs, torch.bfloat16))


@pytest.mark.cuda
def test_wrapper_raises_on_a_bad_row_scale_or_out_dtype(cuda):
    xq, packed, scale, xs = _fused_case(cuda, 4, 256, 16, 128)
    with pytest.raises(ValueError, match='row_scale'):
        qmm.w4a8_matmul(xq, packed, scale, row_scale=xs.double())
    with pytest.raises(ValueError, match='row_scale'):
        qmm.w4a8_matmul(xq, packed, scale, row_scale=xs[:3])
    with pytest.raises(ValueError, match='out_dtype'):
        qmm.w4a8_matmul(xq, packed, scale, out_dtype=torch.int32)
    with pytest.raises(ValueError, match='out_dtype'):
        qmm.w4a8_matmul(xq, packed, scale, out_dtype=torch.float16)
