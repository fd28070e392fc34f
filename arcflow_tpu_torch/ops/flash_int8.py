"""Forward flash attention with an int8 QK^T: the Hopper kernels (the row
quantization and the attention), their wrappers and their plain PyTorch
versions.

Counterpart of ``arcflow_tpu/ops/flash_int8.py``. q and k are quantized per
(batch, token, head) row to symmetric int8 (absmax / 127 with a 1e-6
floor, ``rowwise_int8``); the score of query i and key j is the int8 dot
product rescaled exactly, ``(q_i8 . k_j8) * s_q[i] * s_k[j] / sqrt(D)``;
the softmax runs in fp32 and P.V in bf16. A padded key scores -1e30 (not
-inf), so a batch row with no valid key attends uniformly: its output is
the mean of v in bf16, as the JAX kernel gives it (and as
``models/layers.py:attention`` does), not the O = 0 of the other kernels.

The kernels (``csrc/flash_int8.cu``) replace the TPU kernel
``arcflow_tpu/ops/flash_int8.py:flash_attention_int8``. As in the JAX
package, nothing in serving calls them. The quantization is a kernel of
its own, one launch for q and k (``quantize_qk``; the JAX function
quantizes outside its Pallas call, fused by XLA), and hands the attention
int8 (B, S, H, D) rows and fp32 (B, H, S) scales. A CUDA tensor always
launches the kernels (or the wrapper raises); only a CPU tensor takes the
plain versions, ``quantize_qk_ref`` and ``flash_attention_int8_ref``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ._build import launch_error
from .attention import HEAD_DIM, _check_cuda_args

# Kernel launches since the count was last set to 0, of the attention
# (LAUNCHES) and of the quantization (QUANT_LAUNCHES); each wrapper adds one
# per launch and nothing else touches them except a caller resetting them.
LAUNCHES = 0
QUANT_LAUNCHES = 0

MASKED_SCORE = -1e30       # a padded key's score, as in the JAX kernel
LOG2E = 1.4426950408889634


def rowwise_int8(x: torch.Tensor):
    """Per-row symmetric int8 over the last axis: (..., D) -> ((..., D)
    int8, (..., 1) fp32 scales), absmax / 127 with a 1e-6 floor, round half
    to even, clip to [-127, 127], in fp32 as in the JAX package."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    # by a tensor, not a Python number: PyTorch divides a CUDA tensor by a
    # number as a product with its reciprocal, off the IEEE quotient by an
    # ulp at times, where JAX (and PyTorch on the CPU) divides
    scale = amax / amax.new_full((), 127.0)
    return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale


def quantize_qk_ref(q: torch.Tensor, k: torch.Tensor):
    """The plain version of ``quantize_qk``: ``rowwise_int8`` of q and k,
    laid out as the attention kernel reads them."""
    (qq, qs), (kq, ks) = rowwise_int8(q), rowwise_int8(k)
    return (qq.contiguous(), qs[..., 0].transpose(1, 2).contiguous(),
            kq.contiguous(), ks[..., 0].transpose(1, 2).contiguous())


def quantize_qk(q: torch.Tensor, k: torch.Tensor):
    """The attention kernel's operands from (B, S, H, D) q and k: int8 rows
    (B, S, H, D), contiguous, and fp32 scales (B, H, S), contiguous,
    bitwise ``rowwise_int8``'s. CUDA tensors (bf16 or fp32, D = 128, rows
    as ``ops/attention.py`` checks them) launch the quantization kernel
    once for both; CPU tensors take ``quantize_qk_ref``."""
    if q.device.type == 'cpu':
        return quantize_qk_ref(q, k)
    if q.device.type != 'cuda':
        raise ValueError(f'no int8 quantization kernel for device {q.device}')
    _check_cuda_args(q, k, k, None, dtypes=(torch.bfloat16, torch.float32))
    from ._build import load_library
    lib = load_library()
    b, s, h, d = q.shape
    qq, kq = (torch.empty((b, s, h, d), dtype=torch.int8, device=q.device)
              for _ in range(2))
    qs, ks = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
              for _ in range(2))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.arcflow_quantize_rows_int8(
        q.data_ptr(), k.data_ptr(), int(q.dtype == torch.float32), b, s, h,
        *q.stride()[:3], *k.stride()[:3], qq.data_ptr(), qs.data_ptr(),
        kq.data_ptr(), ks.data_ptr(), stream)
    if err != 0:
        raise RuntimeError('int8 quantization kernel launch failed: '
                           + launch_error(lib, err, ()))
    global QUANT_LAUNCHES
    QUANT_LAUNCHES += 1
    return qq, qs, kq, ks


def scores_ref(qq, qs, kq, ks, sm_scale: float) -> torch.Tensor:
    """(B, H, Sq, Sk) fp32 scores from int8 rows and (B, H, S) scales: the
    integer dot product (exact in fp64, every sum below 2^53) times
    ``s_q * sm_scale`` and then ``s_k``, in the kernel's order."""
    dot = torch.einsum('bqhd,bkhd->bhqk', qq.double(), kq.double()).float()
    return dot * (qs * sm_scale)[..., None] * ks[:, :, None, :]


def flash_attention_int8_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             kv_valid: Optional[torch.Tensor] = None,
                             sm_scale: Optional[float] = None
                             ) -> torch.Tensor:
    """The plain version on (B, S, H, D): the exactly rescaled int8 dot of
    the ``rowwise_int8`` rows, -1e30 for the keys ``kv_valid`` (B, S)
    excludes, fp32 softmax, P (fp32) times v rounded to bf16. Returns q's
    dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = scores_ref(*quantize_qk_ref(q, k), sm_scale)
    if kv_valid is not None:
        s = s.masked_fill(~kv_valid.bool()[:, None, None, :], MASKED_SCORE)
    p = torch.softmax(s, dim=-1)
    vb = v.to(torch.bfloat16).float()
    return torch.einsum('bhqk,bkhd->bqhd', p, vb).to(q.dtype)


def key_scale_rows(ks: torch.Tensor):
    """The key scales as the attention kernel's TMA map reads them: (B H,
    pitch) fp32 rows with pitch = S rounded up to a multiple of 4, since TMA
    steps rows in 16-byte units; ``ks`` itself when S is a multiple of 4,
    else a zero-padded copy. Returns (rows, pitch)."""
    b, h, s = ks.shape
    pitch = -(-s // 4) * 4
    if pitch != s:
        ks = torch.nn.functional.pad(ks, (0, pitch - s))
    return ks.reshape(b * h, pitch), pitch


def launch(qq, qs, kq, ks, v, kv_valid, sm_scale: float,
           out_dtype: torch.dtype) -> torch.Tensor:
    """One kernel launch on prepared operands: int8 (B, S, H, D) q and k
    rows, their fp32 (B, H, S) scales, bf16 v (B, S, H, D) with a contiguous
    last dim and 16-byte aligned rows, an optional bool/uint8 (B, S) key
    mask. Returns O (B, S, H, D) in ``out_dtype`` (bf16 or fp32). Checks
    the operands as the wrapper prepares them; ``flash_attention_int8`` is
    the entry point."""
    b, s, h, d = qq.shape
    for name, t, dt in (('qq', qq, torch.int8), ('kq', kq, torch.int8),
                        ('v', v, torch.bfloat16)):
        if t.dtype != dt or t.shape != qq.shape or t.device != qq.device:
            raise ValueError(f'{name} must be {dt} of shape {tuple(qq.shape)}'
                             f' on {qq.device}')
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:-1]):
            raise ValueError(f'{name} needs a contiguous last dim and '
                             f'16-byte aligned rows')
    for name, t in (('qs', qs), ('ks', ks)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, s)
                or not t.is_contiguous() or t.device != qq.device):
            raise ValueError(f'{name} must be contiguous fp32 (B, H, S) = '
                             f'{(b, h, s)} on {qq.device}')
    ks_rows, ks_pitch = key_scale_rows(ks)
    if ks_rows.data_ptr() % 16:
        raise ValueError('ks needs a 16-byte aligned base (a TMA map reads '
                         'it)')
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'no int8 attention output in {out_dtype}')
    from ._build import load_library
    lib = load_library()
    out = torch.empty((b, s, h, d), dtype=out_dtype, device=qq.device)
    mask_ptr, mask_sb = None, 0
    if kv_valid is not None:
        mask = kv_valid.view(torch.uint8) if kv_valid.dtype == torch.bool \
            else kv_valid
        mask_ptr, mask_sb = mask.data_ptr(), mask.stride(0)
    stream = torch.cuda.current_stream(qq.device).cuda_stream
    err = lib.arcflow_flash_int8(
        qq.data_ptr(), kq.data_ptr(), v.data_ptr(), qs.data_ptr(),
        ks_rows.data_ptr(), mask_ptr, out.data_ptr(), b, s, h,
        int(out_dtype == torch.float32), *qq.stride()[:3], *kq.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], mask_sb, ks_pitch,
        sm_scale * LOG2E, stream)
    if err != 0:
        raise RuntimeError('int8 attention kernel launch failed: '
                           + launch_error(lib, err, ('qq', 'kq', 'v', 'qs',
                                                     'ks')))
    global LAUNCHES
    LAUNCHES += 1
    return out


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid: Optional[torch.Tensor] = None,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Forward attention with an int8 QK^T on (B, S, H, D): the Hopper
    kernel on CUDA tensors.

    CUDA tensors must be bf16 or fp32, all of one dtype, with D = 128, a
    contiguous last dim and aligned rows (``ops/attention.py``'s checks);
    any S is taken. ``kv_valid`` (B, S) bool or uint8 masks keys. CPU
    tensors go to ``flash_attention_int8_ref``. Returns q's dtype.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == 'cpu':
        return flash_attention_int8_ref(q, k, v, kv_valid, sm_scale)
    if q.device.type != 'cuda':
        raise ValueError(f'no int8 attention kernel for device {q.device}')
    _check_cuda_args(q, k, v, kv_valid,
                     dtypes=(torch.bfloat16, torch.float32))
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f'the kernel takes D = {HEAD_DIM}')
    qq, qs, kq, ks = quantize_qk(q, k)
    return launch(qq, qs, kq, ks, v.to(torch.bfloat16), kv_valid, sm_scale,
                  q.dtype)
