"""Non-causal attention forward: the Hopper kernel, its wrapper and its
plain PyTorch version.

The kernel (``csrc/attention_fwd.cu``) replaces the JAX package's two TPU
attention kernels, ``arcflow_tpu/models/layers.py:_splash_call`` and the
forward of ``_flash_call``. A CUDA tensor always launches the kernel (or the
wrapper raises); only a CPU tensor takes ``attention_ref``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# Kernel launches since the count was last set to 0; the wrapper adds one
# per launch and nothing else touches it except a caller resetting it.
LAUNCHES = 0

HEAD_DIM = 128          # the only D the kernel is compiled for


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_valid: Optional[torch.Tensor] = None,
                  return_lse: bool = False):
    """softmax(q k^T / sqrt(D)) v in fp32 on (B, S, H, D) tensors.

    ``kv_valid`` (B, S_kv), bool or uint8, excludes its false keys. Returns
    the output in q's dtype and, with ``return_lse``, the per-row
    log-sum-exp (B, H, S_q) in fp32. A row with no valid key gets output 0
    and LSE -inf, as the kernel does.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if kv_valid is not None:
        logits.masked_fill_(~kv_valid.bool()[:, None, None, :], -math.inf)
    lse = torch.logsumexp(logits, dim=-1)                    # (B, H, S_q)
    probs = logits.sub_(lse[..., None]).exp_()
    probs.masked_fill_(torch.isinf(lse)[..., None], 0.0)     # no valid key
    out = torch.einsum('bhqk,bkhd->bqhd', probs, v.float()).to(q.dtype)
    return (out, lse) if return_lse else out


def _check_cuda_args(q, k, v, kv_valid):
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device != q.device:
            raise ValueError(f'{name} is on {t.device}, q on {q.device}')
        if t.dtype != torch.bfloat16:
            raise ValueError(f'{name} must be bfloat16, got {t.dtype}')
        if t.shape != q.shape:
            raise ValueError(f'{name} shape {tuple(t.shape)} != q shape '
                             f'{tuple(q.shape)}')
        if t.stride(-1) != 1:
            raise ValueError(f'{name} needs a contiguous last dim')
        # 16-byte cp.async rows: base and every stride 8-element aligned
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f'{name} needs 16-byte aligned rows, got '
                             f'strides {t.stride()}')
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f'the kernel takes (B, S, H, {HEAD_DIM}), got '
                         f'{tuple(q.shape)}')
    b, s, h, _ = q.shape
    if s == 0 or b * h == 0 or b * h > 65535:
        raise ValueError(f'unsupported B*H={b * h} or S={s}')
    if kv_valid is not None:
        if tuple(kv_valid.shape) != (b, s):
            raise ValueError(f'kv_valid must be (B, S)=({b}, {s}), got '
                             f'{tuple(kv_valid.shape)}')
        if kv_valid.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f'kv_valid must be bool or uint8, got '
                             f'{kv_valid.dtype}')
        if kv_valid.device != q.device or kv_valid.stride(-1) != 1:
            raise ValueError('kv_valid must be on q\'s device with a '
                             'contiguous last dim')


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[torch.Tensor] = None,
                        return_lse: bool = False):
    """Attention forward on (B, S, H, D): the Hopper kernel on CUDA tensors.

    CUDA tensors must be bf16 with D = 128, a contiguous last dim and
    16-byte aligned rows; anything else raises. CPU tensors go to
    ``attention_ref``. Returns O (B, S, H, D) in q's dtype and, with
    ``return_lse``, the LSE (B, H, S) fp32.
    """
    if q.device.type == 'cpu':
        return attention_ref(q, k, v, kv_valid, return_lse)
    if q.device.type != 'cuda':
        raise ValueError(f'no attention kernel for device {q.device}')
    _check_cuda_args(q, k, v, kv_valid)
    from ._build import load_library
    lib = load_library()
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    mask_ptr, mask_sb = None, 0
    if kv_valid is not None:
        mask = kv_valid.view(torch.uint8) if kv_valid.dtype == torch.bool \
            else kv_valid
        mask_ptr, mask_sb = mask.data_ptr(), mask.stride(0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.arcflow_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
        out.data_ptr(), lse.data_ptr(), b, s, h,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        mask_sb, stream)
    if err != 0:
        raise RuntimeError('attention kernel launch failed: '
                           + lib.arcflow_cuda_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    return (out, lse) if return_lse else out
