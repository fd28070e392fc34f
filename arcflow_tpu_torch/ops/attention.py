"""Non-causal attention, forward and backward: the Hopper kernels, their
wrappers, their plain PyTorch versions and the autograd Function that joins
them.

The forward kernel (``csrc/attention_fwd.cu``) replaces the JAX package's
two TPU attention kernels, ``arcflow_tpu/models/layers.py:_splash_call`` and
the forward of ``_flash_call``; the backward kernels
(``csrc/attention_bwd.cu``) replace the dq/dkv kernels of ``_flash_call``'s
custom VJP. A CUDA tensor always launches the kernels (or the wrapper
raises); only a CPU tensor takes ``attention_ref`` and ``attention_bwd_ref``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import check_no_broadcast, is_broadcast, launch_error

# Kernel launches since the count was last set to 0; each wrapper adds one
# per launch and nothing else touches them except a caller resetting them.
LAUNCHES = 0            # forward kernel
BWD_LAUNCHES = 0        # backward (preprocess + main kernel)

HEAD_DIM = 128          # the only D the kernel is compiled for


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_valid: Optional[torch.Tensor] = None,
                  return_lse: bool = False):
    """softmax(q k^T / sqrt(D)) v in fp32 on (B, S, H, D) tensors.

    ``kv_valid`` (B, S_kv), bool or uint8, excludes its false keys. Returns
    the output in q's dtype and, with ``return_lse``, the per-row
    log-sum-exp (B, H, S_q) in fp32. A row with no valid key gets output 0
    and LSE -inf, as the kernel does. Written out of place, so that autograd
    can differentiate it.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid.bool()[:, None, None, :],
                                    -math.inf)
    lse = torch.logsumexp(logits, dim=-1)                    # (B, H, S_q)
    # no valid key: subtract +inf instead of -inf, so the row's P is 0
    probs = torch.exp(logits - torch.where(torch.isinf(lse), math.inf,
                                           lse)[..., None])
    out = torch.einsum('bhqk,bkhd->bqhd', probs, v.float()).to(q.dtype)
    return (out, lse) if return_lse else out


def _check_cuda_args(q, k, v, kv_valid, dtypes=(torch.bfloat16,), **more):
    """Refuse what the kernels do not take: q, k, v and ``more`` (further
    (B, S, H, D) tensors held to q's rules, the backward's o and dout) on
    one device, of one dtype among ``dtypes``."""
    for name, t in (('q', q), ('k', k), ('v', v), *more.items()):
        if t.device != q.device:
            raise ValueError(f'{name} is on {t.device}, q on {q.device}')
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise ValueError(f'{name} must be one of {dtypes} and q\'s '
                             f'dtype, got {t.dtype}')
        if t.shape != q.shape:
            raise ValueError(f'{name} shape {tuple(t.shape)} != q shape '
                             f'{tuple(q.shape)}')
        if t.stride(-1) != 1:
            raise ValueError(f'{name} needs a contiguous last dim')
        # TMA rows: base and every stride 16-byte (8-element) aligned
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


def _kernel_dout(do: torch.Tensor) -> torch.Tensor:
    """dO as the backward kernels read it: as it lies where its TMA map can
    read it (a contiguous last dim, 16-byte aligned base and strides, no
    broadcast), else a contiguous copy. Autograd hands over dO in whatever
    layout the graph gives it, so the wrapper adapts it where it refuses
    q, k, v and o."""
    if (do.stride(-1) == 1 and do.data_ptr() % 16 == 0
            and not any(st % 8 for st in do.stride()[:-1])
            and not is_broadcast(do)):
        return do
    return do.contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[torch.Tensor] = None,
                        return_lse: bool = False):
    """Attention forward on (B, S, H, D): the Hopper kernel on CUDA tensors.

    CUDA tensors must be bf16 with D = 128, a contiguous last dim, 16-byte
    aligned rows and no broadcast dimension; anything else raises. CPU
    tensors go to ``attention_ref``. Returns O (B, S, H, D) in q's dtype
    and, with ``return_lse``, the LSE (B, H, S) fp32.
    """
    if q.device.type == 'cpu':
        return attention_ref(q, k, v, kv_valid, return_lse)
    if q.device.type != 'cuda':
        raise ValueError(f'no attention kernel for device {q.device}')
    _check_cuda_args(q, k, v, kv_valid)
    check_no_broadcast(q=q, k=k, v=v)
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
                           + launch_error(lib, err, ('q', 'k', 'v')))
    global LAUNCHES
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      kv_valid: Optional[torch.Tensor] = None):
    """Gradients (dq, dk, dv) of ``attention_ref`` in fp32, written out from
    the formulas: with S = q k^T / sqrt(D) and P = exp(S - LSE),

        dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO * O),
        dS = P (dP - delta),  dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D).

    ``o`` and ``lse`` (B, H, S_q) are the forward's outputs. Masked keys and
    rows with LSE -inf (no valid key) get P = 0, so they add nothing and a
    padded key's dk and dv are 0. Returns each gradient in its input's dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum('bqhd,bkhd->bhqk', qf, kf) * scale
    if kv_valid is not None:
        logits.masked_fill_(~kv_valid.bool()[:, None, None, :], -math.inf)
    # -inf LSE (no valid key) -> +inf, so that exp(S - LSE) = 0, not NaN
    lse = torch.where(torch.isinf(lse), math.inf, lse.float())
    probs = logits.sub_(lse[..., None]).exp_()                # (B, H, Sq, Sk)
    dv = torch.einsum('bhqk,bqhd->bkhd', probs, dof)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)         # (B, H, Sq)
    ds = torch.einsum('bqhd,bkhd->bhqk', dof, vf).sub_(
        delta[..., None]).mul_(probs)
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, kf) * scale
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        kv_valid: Optional[torch.Tensor] = None):
    """Attention backward on (B, S, H, D): the Hopper kernels on CUDA
    tensors (preprocess and main kernel; one count in ``BWD_LAUNCHES``).

    q, k, v and o are read through their strides and held to the forward's
    rules; so is ``do``, which is copied only where the kernel cannot read
    it as it lies (``_kernel_dout``).
    ``lse`` is the forward's (B, H, S) fp32 output. CPU tensors go to
    ``attention_bwd_ref``. Returns (dq, dk, dv), contiguous, bf16.
    """
    if q.device.type == 'cpu':
        return attention_bwd_ref(q, k, v, o, do, lse, kv_valid)
    if q.device.type != 'cuda':
        raise ValueError(f'no attention kernel for device {q.device}')
    do = _kernel_dout(do)
    _check_cuda_args(q, k, v, kv_valid, o=o, dout=do)
    check_no_broadcast(q=q, k=k, v=v, o=o)
    b, s, h, d = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f'lse must be contiguous fp32 (B, H, S) = '
                         f'{(b, h, s)} on {q.device}, got {lse.dtype} '
                         f'{tuple(lse.shape)}')
    from ._build import load_library
    lib = load_library()
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    # fp32 workspace: padded LSE and delta rows, dQ tile counters, dQ scratch
    work = torch.empty(lib.arcflow_attention_bwd_workspace_bytes(b, s, h) // 4,
                       dtype=torch.float32, device=q.device)
    mask_ptr, mask_sb = None, 0
    if kv_valid is not None:
        mask = kv_valid.view(torch.uint8) if kv_valid.dtype == torch.bool \
            else kv_valid
        mask_ptr, mask_sb = mask.data_ptr(), mask.stride(0)
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.arcflow_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), mask_ptr, work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h, strides, mask_sb, stream)
    if err != 0:
        raise RuntimeError('attention backward kernel launch failed: '
                           + launch_error(lib, err, ('q', 'k', 'v', 'o',
                                                      'dout')))
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a hand-written backward: the counterpart of
    ``_flash_call``'s custom VJP. The forward keeps q, k, v, O and the LSE;
    the backward recomputes P from them. ``kv_valid`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid):
        out, lse = flash_attention_fwd(q, k, v, kv_valid, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, kv_valid)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_valid = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, kv_valid)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on (B, S, H, D), differentiable in q, k and
    v: the kernels on CUDA tensors, the plain versions on CPU tensors."""
    return FlashAttention.apply(q, k, v, kv_valid)
