"""int8 x int8 -> int32 matrix product of the w8a8 layers: the library call
on the card, its wrapper and its plain PyTorch version.

The JAX package ran this dot in XLA (``lax.dot_general`` with an int32
result, ``arcflow_tpu/models/layers.py:184-186``), outside any Pallas
kernel, so on the card it stays one library call: ``torch._int_mm``
(cuBLASLt). The weight is read as an (in, out) column-major matrix, the
bytes of an (out, in) row-major one, which is the operand layout cuBLASLt's
int8 product takes without a copy. ``torch._int_mm`` on CUDA wants more
than 16 rows and K, N multiples of 8; the FLUX modulations and embedders
run at M = batch, so fewer rows are zero-padded to ``MIN_ROWS``, which adds
zero rows to the product and changes none of the others. A CUDA tensor
always goes to the library call (or the wrapper raises); only a CPU tensor
takes ``int8_matmul_ref``.
"""

from __future__ import annotations

import torch

# Library launches since the count was last set to 0; the wrapper adds one
# per call and nothing else touches it except a caller resetting it.
LAUNCHES = 0

MIN_ROWS = 32       # rows a CUDA call gets at least (zero rows appended)


def int8_matmul_ref(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: (M, K) int8 x (K, N) int8 -> (M, N) int32, as an
    fp64 product, which is exact here (every partial sum is an integer
    below K * 127^2 < 2^53)."""
    return (xq.double() @ w.double()).to(torch.int32)


def _check_cuda_args(xq: torch.Tensor, w: torch.Tensor) -> None:
    if xq.dim() != 2 or w.dim() != 2:
        raise ValueError('int8_matmul takes xq (M, K) and w (K, N)')
    for name, t in (('xq', xq), ('w', w)):
        if t.dtype != torch.int8:
            raise ValueError(f'{name} must be int8, got {t.dtype}')
        if t.device != xq.device:
            raise ValueError(f'{name} is on {t.device}, xq on {xq.device}')
    (m, k), (kw, n) = xq.shape, w.shape
    if k != kw:
        raise ValueError(f'inner sizes differ: xq {tuple(xq.shape)}, w '
                         f'{tuple(w.shape)}')
    if m == 0 or k % 8 or n % 8 or k == 0 or n == 0:
        raise ValueError(f'int8 product needs M > 0 and K, N positive '
                         f'multiples of 8, got M={m} K={k} N={n}')


def int8_matmul(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32: ``torch._int_mm`` on CUDA
    tensors (M below ``MIN_ROWS`` zero-padded), ``int8_matmul_ref`` on CPU
    tensors."""
    if xq.device.type == 'cpu':
        return int8_matmul_ref(xq, w)
    if xq.device.type != 'cuda':
        raise ValueError(f'no int8 product for device {xq.device}')
    _check_cuda_args(xq, w)
    m = xq.shape[0]
    if m < MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros(MIN_ROWS - m, xq.shape[1])])
    out = torch._int_mm(xq.contiguous(), w)
    global LAUNCHES
    LAUNCHES += 1
    return out[:m]
