"""Ring (context-parallel) attention over the sequence-parallel ranks.

Counterpart of ``arcflow_tpu/parallel/ring_attention.py``. Each rank keeps
its sequence shard of q, k and v; the K/V blocks, and their key validity,
rotate around the ring (rank r sends to r + 1 and receives from r - 1), and
every hop folds the visiting block into an fp32 carry with the ring-hop
kernel (``ops/ring_hop.py``, K4). At hop j rank r holds the block that
started on rank (r - j) mod size, as the JAX ``ppermute`` over
``[(j, j + 1)]`` gives it. No rank ever holds the full sequence.

``LocalRing(size)`` is the same ring in one process: all ``size`` shards
sit on one device, the same hops run in the same order through the same
kernel, and the rotation is a re-indexing. It is the counterpart of the
simulated devices the JAX tests run on; ``ArcFluxPipeline.shard`` never
picks it.

A batch row with no valid key on any shard gets the mean of v over all S
keys, as ``models/layers.py:attention`` gives it on one device (and as the
JAX plain tier does). The JAX flash tier, the one that runs the TPU hop,
gives such a row 0 instead (``ring_attention.py:183-190, 203``); the port
does not copy that.

Training: ``ring_attention`` is differentiable in q, k and v (the
counterpart of JAX ``_ring_local_flash`` and its VJP, ``ring_attention.py:
202-225``, which recomputes through the plain tier). The forward keeps q,
k, v, O and the LSE; the backward runs n hops of the attention backward
kernel (``ops/attention.py:flash_attention_bwd``, K3) on the forward's
rotation schedule, each with the shard's *global* O and LSE, which give the
exact partial dQ, dK and dV of the visiting block (P = exp(S - LSE), delta
= rowsum(dO O)). dQ accumulates in place in fp32; each block's fp32 dK / dV
accumulators travel with the block and take one last rotation home
(``_home``). A keyless row's output, the mean of v, adds sum_q dO / S to
every key's dv, added to each visiting block on the same rotation. CPU
tensors take ``attention_bwd_ref`` per hop.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops import attention as attn_ops
from ..ops.ring_hop import ring_hop


class LocalRing:
    """The one-process schedule of a ring of ``size`` sequence shards."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f'a ring needs at least one shard, got {size}')
        self.size = size


def ring_partition(q_shape: Sequence[int], size: int) -> int:
    """The shard length of a (B, S, H, D) sequence cut into ``size``
    shards: S must divide evenly; the head count need not (the ring's
    advantage over Ulysses)."""
    if q_shape[1] % size:
        raise ValueError(f'ring attention needs S % sp == 0, got S='
                         f'{q_shape[1]} over {size} shards')
    return q_shape[1] // size


def _block_stats(v, kv_valid):
    """With a key mask, a block's fp32 sum of v over its keys (B, H, D) and
    whether any of its keys is valid (B,); None without one."""
    if kv_valid is None:
        return None
    return v.sum(dim=1, dtype=torch.float32), kv_valid.bool().any(dim=1)


def _hop(q, k, v, kv_valid, state, last):
    """Fold one visiting block into a shard's state: the kernel's carry and,
    with a key mask, the running fp32 sum of v and whether any key was
    valid (``_block_stats`` of the block)."""
    carry, v_sum, has_key = state
    carry, out = ring_hop(q, k, v, kv_valid, carry, last)
    stats = _block_stats(v, kv_valid)
    if stats is not None:
        blk, any_valid = stats
        v_sum = blk if v_sum is None else v_sum + blk
        has_key = any_valid if has_key is None else has_key | any_valid
    return (carry, v_sum, has_key), out


def _finish(out, state, s_total):
    """The shard's output (keyless rows get the mean of v), its log-sum-exp
    (B, H, Sq) = m + log l and whether each batch row has a valid key
    (None without a key mask)."""
    (_, m, l), v_sum, has_key = state
    if v_sum is not None:
        v_mean = (v_sum / s_total)[:, None].to(out.dtype)      # (B, 1, H, D)
        out = torch.where(has_key[:, None, None, None], out, v_mean)
    return out, m + torch.log(l), has_key


def _rotation(ring, blocks):
    """Start passing each shard's block (a tuple of tensors, None for a
    missing one) to the next shard; returns a function that waits and gives
    the blocks each shard holds next. ``blocks`` lists every shard's block
    on a ``LocalRing`` (a re-indexing) and this rank's alone on a real ring
    (sent to the next rank, received from the previous one)."""
    if isinstance(ring, LocalRing):
        return lambda: blocks[-1:] + blocks[:-1]
    block = blocks[0]
    dst = dist.get_global_rank(ring.group, (ring.rank + 1) % ring.size)
    src = dist.get_global_rank(ring.group, (ring.rank - 1) % ring.size)
    sends = [t.contiguous() for t in block if t is not None]
    recvs = [torch.empty_like(t) for t in sends]
    reqs = dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, t, dst, ring.group, tag=i)
         for i, t in enumerate(sends)]
        + [dist.P2POp(dist.irecv, t, src, ring.group, tag=i)
           for i, t in enumerate(recvs)])

    def wait():
        for req in reqs:
            req.wait()
        got = iter(recvs)
        return [tuple(None if t is None else next(got) for t in block)]
    return wait


def _home(ring, accumulators):
    """The last rotation of the backward: each block's dK / dV accumulators
    go from the shard that folded it last to the shard it started on."""
    return _rotation(ring, accumulators)


def _shards(ring, *tensors, dim=1):
    """Each tensor cut into the ring's shards along ``dim`` (contiguous) on
    a ``LocalRing``, or as it is (this rank's shard) on a real ring."""
    if not isinstance(ring, LocalRing):
        return [[t] for t in tensors]
    return [None if t is None else
            [p.contiguous() for p in t.chunk(ring.size, dim=dim)]
            for t in tensors]


def _ring_forward(q, k, v, mask, ring):
    """The hops: (O, LSE, has_key) of every shard of q, concatenated on a
    ``LocalRing``; the next rotation is issued before each hop's kernels."""
    n = ring.size
    if isinstance(ring, LocalRing):
        ring_partition(q.shape, n)
        ring_partition(k.shape, n)
        s_total = k.shape[1]
    else:
        s_total = n * k.shape[1]
    qs, ks, vs, masks = _shards(ring, q, k, v, mask)
    masks = masks or [None] * len(qs)
    blocks = list(zip(ks, vs, masks))
    states, outs = [(None, None, None)] * len(qs), [None] * len(qs)
    for j in range(n):
        pending = _rotation(ring, blocks) if j + 1 < n else None
        for r, q_r in enumerate(qs):
            states[r], outs[r] = _hop(q_r, *blocks[r], states[r],
                                      last=j + 1 == n)
        if pending is not None:
            blocks = pending()
    shards = [_finish(o, st, s_total) for o, st in zip(outs, states)]
    out = torch.cat([o for o, _, _ in shards], dim=1)
    lse = torch.cat([x for _, x, _ in shards], dim=-1)
    return out, lse, shards[0][2]


def _ring_backward(ring, q, k, v, mask, out, lse, dout, has_key):
    """(dq, dk, dv) of the ring: n hops of the attention backward on the
    forward's schedule. dQ of every query shard accumulates in fp32; the
    visiting block's fp32 (dK, dV) accumulators travel with it and go home
    after the last hop; keyless rows' dv (sum_q dO / S for every key) rides
    along."""
    n = ring.size
    s_total = k.shape[1] if isinstance(ring, LocalRing) else n * k.shape[1]
    qs, os_, dos, ks, vs, masks = _shards(ring, q, out, dout, k, v, mask)
    (lses,) = _shards(ring, lse, dim=-1)
    masks = masks or [None] * len(qs)
    keyless = [None] * len(qs)
    if has_key is not None:
        gone = ~has_key[:, None, None]                          # (B, 1, 1)
        keyless = [torch.where(gone, do.sum(dim=1, dtype=torch.float32)
                               / s_total, 0.0)[:, None] for do in dos]
    blocks = list(zip(ks, vs, masks))
    dqs = [torch.zeros(q_r.shape, dtype=torch.float32, device=q.device)
           for q_r in qs]
    held = pending_acc = None
    for j in range(n):
        pending = _rotation(ring, blocks) if j + 1 < n else None
        parts = [attn_ops.flash_attention_bwd(q_r, k_b, v_b, o_r, do_r,
                                              lse_r, m_b)
                 for q_r, o_r, do_r, lse_r, (k_b, v_b, m_b)
                 in zip(qs, os_, dos, lses, blocks)]
        for dq, (dq_p, _, _) in zip(dqs, parts):
            dq.add_(dq_p)
        # the accumulators of the blocks held now: zero at the first hop,
        # else what the previous shard sent after its hop
        held = [(None, None)] * len(qs) if pending_acc is None \
            else pending_acc()
        accs = []
        for (dk_acc, dv_acc), (_, dk_p, dv_p), extra in zip(held, parts,
                                                           keyless):
            dk_acc = dk_p.float() if dk_acc is None else dk_acc.add_(dk_p)
            dv_acc = dv_p.float() if dv_acc is None else dv_acc.add_(dv_p)
            if extra is not None:
                dv_acc = dv_acc.add_(extra)
            accs.append((dk_acc, dv_acc))
        pending_acc = (_home if j + 1 == n else _rotation)(ring, accs)
        if pending is not None:
            blocks = pending()
    home = pending_acc()
    dq = torch.cat(dqs, dim=1).to(q.dtype)
    dk = torch.cat([a for a, _ in home], dim=1).to(k.dtype)
    dv = torch.cat([b for _, b in home], dim=1).to(v.dtype)
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """The ring with its hand-written backward. ``kv_valid`` and the ring
    get no gradient; the LSE is an output without one."""

    @staticmethod
    def forward(ctx, q, k, v, mask, ring):
        out, lse, has_key = _ring_forward(q, k, v, mask, ring)
        ctx.ring = ring
        ctx.save_for_backward(q, k, v, mask, out, lse, has_key)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, out, lse, has_key = ctx.saved_tensors
        dq, dk, dv = _ring_backward(ctx.ring, q, k, v, mask, out, lse, dout,
                                    has_key)
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: Optional[torch.Tensor], ring,
                   return_lse: bool = False):
    """Non-causal softmax(q k^T / sqrt(D)) v on (B, S, H, D) with the
    sequence cut over a ring of ``size`` shards, one K4 hop per shard and
    visiting block; differentiable in q, k and v (n K3 hops per shard in
    the backward).

    ``ring`` is a ``LocalRing`` (q, k, v and ``kv_valid`` (B, S) are the
    full sequence on one device and so is the result) or the
    ``SequenceParallel`` state of this rank (``group``, ``rank``, ``size``;
    q, k, v and ``kv_valid`` are this rank's shard and so is the result).
    Both run one hop schedule: at hop j every shard folds the block it
    holds, and the next rotation is issued before the hop's kernels. With
    ``return_lse`` also returns the log-sum-exp (B, H, S) in fp32.
    """
    mask = None if kv_valid is None else kv_valid.to(torch.uint8)
    out, lse = _RingAttention.apply(q, k, v, mask, ring)
    return (out, lse) if return_lse else out
