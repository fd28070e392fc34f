"""One hop of ring attention: the Hopper kernel, its wrapper and its plain
PyTorch version.

The kernel (``csrc/ring_hop.cu``) replaces the JAX package's TPU ring hop,
``arcflow_tpu/parallel/ring_attention.py:_hop_stats_pallas``, together with
the fp32 merge ``_ring_flash_core`` runs after every hop (lines 187-190):
it folds the visiting K/V block into a running fp32 carry ``(acc, m, l)``
over the keys seen so far,

    m = max_j s_j,   l = sum_j exp(s_j - m),   acc = sum_j exp(s_j - m) v_j,

with s_j = q.k_j / sqrt(D), m in natural-log units and -inf while no valid
key has been seen. The first hop of a ring starts the carry; the last also
gives O = acc / l (0 where l = 0). A CUDA tensor always launches the kernel
(or the wrapper raises); only a CPU tensor takes ``ring_hop_ref``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ._build import check_no_broadcast, launch_error

# Kernel launches since the count was last set to 0; the wrapper adds one per
# launch and nothing else touches it except a caller resetting it.
LAUNCHES = 0

HEAD_DIM = 128          # the only D the kernel is compiled for

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ring_hop_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_valid: Optional[torch.Tensor] = None,
                 carry: Optional[Carry] = None, last: bool = False
                 ) -> Tuple[Carry, Optional[torch.Tensor]]:
    """The hop in fp32, out of place: q (B, Sq, H, D), k and v (B, Skv, H,
    D), ``kv_valid`` (B, Skv) bool or uint8, ``carry`` (acc (B, Sq, H, D),
    m (B, H, Sq), l (B, H, Sq)) or None for the first hop. Returns the new
    carry and, with ``last``, O in q's dtype (else None)."""
    b, sq, h, d = q.shape
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) / math.sqrt(d)
    if kv_valid is not None:
        s = s.masked_fill(~kv_valid.bool()[:, None, None, :], -math.inf)
    if carry is None:
        acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, sq), -math.inf, device=q.device)
        l = torch.zeros((b, h, sq), device=q.device)
    else:
        acc, m, l = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    # no valid key so far: exponentiate against 0, so exp(-inf) = 0, not NaN
    ref = torch.where(m_new == -math.inf, 0.0, m_new)
    p = torch.exp(s - ref[..., None])
    corr = torch.exp(m - ref)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
        'bhqk,bkhd->bqhd', p, v.float())
    out = None
    if last:
        l_t = l_new.transpose(1, 2)[..., None]
        out = torch.where(l_t > 0, acc_new / l_t, 0.0).to(q.dtype)
    return (acc_new, m_new, l_new), out


def _check_bf16(name, t, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, q on {device}')
    if t.dtype != torch.bfloat16:
        raise ValueError(f'{name} must be bfloat16, got {t.dtype}')
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM or t.stride(-1) != 1:
        raise ValueError(f'the kernel takes {name} as (B, S, H, {HEAD_DIM}) '
                         f'with a contiguous last dim, got {tuple(t.shape)} '
                         f'strides {t.stride()}')
    # TMA rows: base and every stride 16-byte (8-element) aligned
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f'{name} needs 16-byte aligned rows, got strides '
                         f'{t.stride()}')
    check_no_broadcast(**{name: t})


def _check_cuda_args(q, k, v, kv_valid, carry):
    """Refuse what the kernel does not take."""
    for name, t in (('q', q), ('k', k), ('v', v)):
        _check_bf16(name, t, q.device)
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    if v.shape != k.shape or (k.shape[0], k.shape[2]) != (b, h):
        raise ValueError(f'k {tuple(k.shape)} and v {tuple(v.shape)} must be '
                         f'(B, Skv, H, D) with q\'s B={b}, H={h}')
    if sq == 0 or skv == 0 or b * h == 0 or b * h > 65535:
        raise ValueError(f'unsupported B*H={b * h}, Sq={sq} or Skv={skv}')
    if kv_valid is not None:
        if tuple(kv_valid.shape) != (b, skv):
            raise ValueError(f'kv_valid must be (B, Skv)=({b}, {skv}), got '
                             f'{tuple(kv_valid.shape)}')
        if kv_valid.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f'kv_valid must be bool or uint8, got '
                             f'{kv_valid.dtype}')
        if kv_valid.device != q.device or kv_valid.stride(-1) != 1:
            raise ValueError('kv_valid must be on q\'s device with a '
                             'contiguous last dim')
    if carry is not None:
        shapes = ((b, sq, h, HEAD_DIM), (b, h, sq), (b, h, sq))
        for name, t, shape in zip(('acc', 'm', 'l'), carry, shapes):
            if (t.dtype != torch.float32 or tuple(t.shape) != shape
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f'{name} must be contiguous fp32 {shape} on '
                                 f'{q.device}, got {t.dtype} '
                                 f'{tuple(t.shape)}')


def ring_hop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             kv_valid: Optional[torch.Tensor] = None,
             carry: Optional[Carry] = None, last: bool = False
             ) -> Tuple[Carry, Optional[torch.Tensor]]:
    """Fold one visiting K/V block into the carry: the Hopper kernel on CUDA
    tensors, ``ring_hop_ref`` on CPU tensors.

    On CUDA, q, k and v must be bf16 with D = 128, a contiguous last dim,
    16-byte aligned rows and no broadcast dimension; the carry is updated
    in place (a first hop, with ``carry`` None, allocates it) and returned.
    Returns (carry, O), with O (B, Sq, H, D) bf16 when ``last``, else None.
    """
    if q.device.type == 'cpu':
        return ring_hop_ref(q, k, v, kv_valid, carry, last)
    if q.device.type != 'cuda':
        raise ValueError(f'no ring hop kernel for device {q.device}')
    _check_cuda_args(q, k, v, kv_valid, carry)
    from ._build import load_library
    lib = load_library()
    b, sq, h, d = q.shape
    first = carry is None
    if first:
        carry = (torch.empty((b, sq, h, d), dtype=torch.float32,
                             device=q.device),
                 *(torch.empty((b, h, sq), dtype=torch.float32,
                               device=q.device) for _ in range(2)))
    acc, m, l = carry
    out, o_ptr, o_strides = None, None, (0, 0, 0)
    if last:
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        o_ptr, o_strides = out.data_ptr(), out.stride()[:3]
    mask_ptr, mask_sb = None, 0
    if kv_valid is not None:
        mask = kv_valid.view(torch.uint8) if kv_valid.dtype == torch.bool \
            else kv_valid
        mask_ptr, mask_sb = mask.data_ptr(), mask.stride(0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.arcflow_ring_hop(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), o_ptr, b, sq, k.shape[1], h,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o_strides,
        mask_sb, int(first), int(last), stream)
    if err != 0:
        raise RuntimeError('ring hop kernel launch failed: ' + launch_error(
            lib, err, ('q', 'k', 'v', 'acc')))
    global LAUNCHES
    LAUNCHES += 1
    return carry, out
