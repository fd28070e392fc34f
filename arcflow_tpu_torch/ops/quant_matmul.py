"""w4a8 grouped matmul: the Hopper kernel, its wrapper and its plain
PyTorch version.

``out[m, n] = sum_g scale[g, n] * sum_{k in g} xq[m, k] * w4[k, n]`` for
int8 activations ``xq`` (M, K), int4 weights nibble-packed (K/2, N) in the
group-local half-split layout of ``utils/quantize.py:pack_int4``, and fp32
scales (G, N); the output is (M, N) fp32. With ``row_scale`` (M, 1) fp32,
the per-token activation scale, it is ``(out * row_scale).to(out_dtype)``
instead, which the kernel computes in its epilogue: the same fp32 product
and the same rounding as scaling the fp32 output afterwards. The kernel
(``csrc/w4a8_matmul.cu``) replaces the JAX package's TPU kernel
``arcflow_tpu/ops/quant_matmul.py:w4a8_matmul_pallas``. A CUDA tensor
always launches the kernel (or the wrapper raises), whatever M is; only a
CPU tensor takes ``w4a8_matmul_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.quantize import unpack_nibbles
from ._build import launch_error

# Kernel launches since the count was last set to 0; the wrapper adds one
# per launch and nothing else touches it except a caller resetting it.
LAUNCHES = 0

GROUP_SIZES = (32, 64, 128)     # the scale groups the kernel takes
# the kernel's output types, by the code its entry point takes
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def w4a8_matmul_ref(xq: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor,
                    row_scale: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version: one product per scale group on integer-valued
    fp32 operands, times the group's scale, summed over groups in fp32;
    then times ``row_scale`` (M, 1) in fp32, if given, and cast to
    ``out_dtype``.

    Every per-group partial sum is an integer below 2^24, so it is exact in
    fp32 (on a card only with TF32 off); only the fp32 sum over groups
    rounds.
    """
    g = scale.shape[0]
    ph = packed.shape[0] // g                   # packed rows per group
    lo, hi = unpack_nibbles(packed)
    x = xq.float().reshape(xq.shape[0], g, 2, ph)
    lo = lo.float().reshape(g, ph, -1)
    hi = hi.float().reshape(g, ph, -1)
    out = torch.zeros(xq.shape[0], packed.shape[1], dtype=torch.float32,
                      device=xq.device)
    for i in range(g):
        part = x[:, i, 0] @ lo[i] + x[:, i, 1] @ hi[i]
        out += part * scale[i].float()
    if row_scale is not None:
        out = out * row_scale.reshape(-1, 1)
    return out.to(out_dtype)


def _check_cuda_args(xq, packed, scale, row_scale, out_dtype):
    if xq.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError('w4a8_matmul takes xq (M, K), packed (K/2, N), '
                         'scale (G, N)')
    for name, t, dt in (('xq', xq, torch.int8), ('packed', packed, torch.int8),
                        ('scale', scale, torch.float32)):
        if t.device != xq.device:
            raise ValueError(f'{name} is on {t.device}, xq on {xq.device}')
        if t.dtype != dt:
            raise ValueError(f'{name} must be {dt}, got {t.dtype}')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous and 16-byte aligned')
    m, k = xq.shape
    kp, n = packed.shape
    g = scale.shape[0]
    if m == 0 or k == 0 or n == 0:
        raise ValueError(f'empty w4a8 matmul: M={m} K={k} N={n}')
    if k != 2 * kp or scale.shape[1] != n or k % g:
        raise ValueError(f'inconsistent shapes: xq {tuple(xq.shape)}, packed '
                         f'{tuple(packed.shape)}, scale {tuple(scale.shape)}')
    if k // g not in GROUP_SIZES:
        raise ValueError(f'group size {k // g} not in {GROUP_SIZES}')
    if n % 8:
        raise ValueError(f'N={n} must be a multiple of 8')
    if m > 65535 * 128:
        raise ValueError(f'M={m} is too large for one launch')
    if row_scale is not None:
        if (row_scale.dtype != torch.float32 or row_scale.numel() != m
                or row_scale.device != xq.device
                or not row_scale.is_contiguous()):
            raise ValueError(f'row_scale must be contiguous fp32 (M, 1) = '
                             f'({m}, 1) on {xq.device}, got '
                             f'{row_scale.dtype} {tuple(row_scale.shape)}')
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f'out_dtype {out_dtype} not in '
                         f'{tuple(OUT_DTYPES)}')


def w4a8_matmul(xq: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor,
                row_scale: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M, K) int8 x nibble-packed (K/2, N) int4 with (G, N) fp32 scales ->
    (M, N) ``out_dtype``, times ``row_scale`` (M, 1) fp32 if given: the
    Hopper kernel on CUDA tensors.

    CUDA tensors must be contiguous and 16-byte aligned, with a group size
    K/G in (32, 64, 128), N a multiple of 8 and ``out_dtype`` fp32 or bf16;
    anything else raises. Where N is not a multiple of 16, the packed
    weight and the scale are padded to it per call (the kernel's TMA loads
    step rows in 16 bytes). CPU tensors go to ``w4a8_matmul_ref``.
    """
    if xq.device.type == 'cpu':
        return w4a8_matmul_ref(xq, packed, scale, row_scale, out_dtype)
    if xq.device.type != 'cuda':
        raise ValueError(f'no w4a8 kernel for device {xq.device}')
    _check_cuda_args(xq, packed, scale, row_scale, out_dtype)
    from ._build import load_library
    lib = load_library()
    m, k = xq.shape
    n = packed.shape[1]
    n_pad = -(-n // 16) * 16
    if n_pad != n:
        packed = F.pad(packed, (0, n_pad - n))
        scale = F.pad(scale, (0, n_pad - n))
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.arcflow_w4a8_matmul(
        xq.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        None if row_scale is None else row_scale.data_ptr(), out.data_ptr(),
        m, n, n_pad, k, k // scale.shape[0], OUT_DTYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError('w4a8 kernel launch failed: ' + launch_error(
            lib, err, ('xq', 'packed')))
    global LAUNCHES
    LAUNCHES += 1
    return out
