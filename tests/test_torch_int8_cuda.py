"""The int8 x int8 -> int32 product of the w8a8 layers
(``ops/int8_matmul.py``, ``torch._int_mm`` on the card) against its exact
plain version, on the card.

Marked ``cuda``: they skip without a CUDA device. This file imports no
JAX: ``python -m pytest --noconftest -q tests/test_torch_int8_cuda.py``.
The product is exact in both (int32 on the card, fp64 in the plain
version), so the results must be equal.
"""

import pytest
import torch

from arcflow_tpu_torch.models import layers
from arcflow_tpu_torch.ops import int8_matmul as i8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.Generator(device='cuda').manual_seed(0)


def _case(g, m, k, n):
    xq = torch.randint(-127, 128, (m, k), generator=g, device='cuda',
                       dtype=torch.int8)
    w_t = torch.randint(-127, 128, (n, k), generator=g, device='cuda',
                        dtype=torch.int8)
    return xq, w_t.t()                     # (K, N) column-major, as stored


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n', [(1, 3072, 18432), (1, 256, 3072),
                                   (2, 768, 3072), (16, 64, 3072),
                                   (17, 3072, 3072), (512, 4096, 3072),
                                   (4608, 15360, 3072), (100, 72, 24)])
def test_product_is_exact(cuda, m, k, n):
    xq, w = _case(cuda, m, k, n)
    before = i8.LAUNCHES
    got = i8.int8_matmul(xq, w)
    torch.cuda.synchronize()
    assert i8.LAUNCHES == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, i8.int8_matmul_ref(xq, w))


@pytest.mark.cuda
def test_extremes_are_exact(cuda):
    xq, w = _case(cuda, 33, 15360, 64)
    xq[0] = -127
    w[:, 0] = -127
    assert torch.equal(i8.int8_matmul(xq, w), i8.int8_matmul_ref(xq, w))


@pytest.mark.cuda
@pytest.mark.parametrize('lead', [(1,), (1, 4096)])
def test_w8a8_layer_matches_plain_product(cuda, lead):
    """A w8a8 ``LoRADense`` on the card: the library product and the plain
    one give the same layer output bit for bit."""
    from unittest import mock
    from arcflow_tpu_torch.utils.quantize import quantize_weights_int8
    layer = layers.LoRADense(3072, 3072, device='cuda', dtype=torch.bfloat16)
    quantize_weights_int8(layer, act_quant=True)
    x = torch.randn(*lead, 3072, generator=cuda, device='cuda',
                    dtype=torch.bfloat16)
    with torch.no_grad():
        got = layer(x)
        with mock.patch.object(i8, 'int8_matmul', i8.int8_matmul_ref):
            want = layer(x)
    assert torch.equal(got, want)
