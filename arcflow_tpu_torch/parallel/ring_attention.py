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

Inference only: the backward (the JAX package rematerializes it through its
plain tier) waits for training under ``sp`` (ROADMAP A12).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

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


def check_no_autograd(*tensors: torch.Tensor) -> None:
    """Sequence-parallel attention has no backward yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            'sequence-parallel attention is inference only: training under '
            'sp waits for its backward (ROADMAP A12)')


def _block_stats(v, kv_valid):
    """With a key mask, a block's fp32 sum of v over its keys (B, H, D) and
    whether any of its keys is valid (B,); None without one."""
    if kv_valid is None:
        return None
    return v.sum(dim=1, dtype=torch.float32), kv_valid.bool().any(dim=1)


def _hop(q, k, v, kv_valid, stats, state, last):
    """Fold one visiting block into a shard's state: the kernel's carry and,
    with a key mask, the running fp32 sum of v and whether any key was
    valid, from the block's ``stats``."""
    carry, v_sum, has_key = state
    carry, out = ring_hop(q, k, v, kv_valid, carry, last)
    if stats is not None:
        blk, any_valid = stats
        v_sum = blk if v_sum is None else v_sum + blk
        has_key = any_valid if has_key is None else has_key | any_valid
    return (carry, v_sum, has_key), out


def _finish(out, state, s_total, return_lse):
    """The shard's output (keyless rows get the mean of v) and, with
    ``return_lse``, its log-sum-exp (B, H, Sq) = m + log l."""
    (_, m, l), v_sum, has_key = state
    if v_sum is not None:
        v_mean = (v_sum / s_total)[:, None].to(out.dtype)      # (B, 1, H, D)
        out = torch.where(has_key[:, None, None, None], out, v_mean)
    return (out, m + torch.log(l)) if return_lse else out


def _rotation(ring, blocks):
    """Start passing each shard's block (k, v, mask, ``_block_stats``) to
    the next shard; returns a function that waits and gives the blocks each
    shard holds next. ``blocks`` lists every shard's block on a
    ``LocalRing`` (a re-indexing: the stats travel with their block) and
    this rank's alone on a real ring (k, v and mask sent to the next rank
    and received from the previous one, the stats taken of what arrived)."""
    if isinstance(ring, LocalRing):
        return lambda: blocks[-1:] + blocks[:-1]
    block = blocks[0][:3]
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
        k, v, mask = (None if t is None else next(got) for t in block)
        return [(k, v, mask, _block_stats(v, mask))]
    return wait


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: Optional[torch.Tensor], ring,
                   return_lse: bool = False):
    """Non-causal softmax(q k^T / sqrt(D)) v on (B, S, H, D) with the
    sequence cut over a ring of ``size`` shards, one K4 hop per shard and
    visiting block.

    ``ring`` is a ``LocalRing`` (q, k, v and ``kv_valid`` (B, S) are the
    full sequence on one device and so is the result) or the
    ``SequenceParallel`` state of this rank (``group``, ``rank``, ``size``;
    q, k, v and ``kv_valid`` are this rank's shard and so is the result).
    Both run one hop schedule: at hop j every shard folds the block it
    holds, and the next rotation is issued before the hop's kernels. With
    ``return_lse`` also returns the log-sum-exp (B, H, S) in fp32.
    """
    check_no_autograd(q, k, v)
    mask = None if kv_valid is None else kv_valid.to(torch.uint8)
    n = ring.size
    if isinstance(ring, LocalRing):
        sq = ring_partition(q.shape, n)
        ring_partition(k.shape, n)
        qs, ks, vs = ([t.contiguous() for t in x.split(sq, dim=1)]
                      for x in (q, k, v))
        masks = [None] * n if mask is None else \
            [t.contiguous() for t in mask.split(sq, dim=1)]
        blocks = [(k_b, v_b, m_b, _block_stats(v_b, m_b))
                  for k_b, v_b, m_b in zip(ks, vs, masks)]
        s_total = k.shape[1]
    else:
        qs, s_total = [q], n * k.shape[1]
        blocks = [(k, v, mask, _block_stats(v, mask))]
    states, outs = [(None, None, None)] * len(qs), [None] * len(qs)
    for j in range(n):
        pending = _rotation(ring, blocks) if j + 1 < n else None
        for r, q_r in enumerate(qs):
            states[r], outs[r] = _hop(q_r, *blocks[r], states[r],
                                      last=j + 1 == n)
        if pending is not None:
            blocks = pending()
    shards = [_finish(o, st, s_total, return_lse)
              for o, st in zip(outs, states)]
    if len(shards) == 1:
        return shards[0]
    if not return_lse:
        return torch.cat(shards, dim=1)
    return (torch.cat([o for o, _ in shards], dim=1),
            torch.cat([lse for _, lse in shards], dim=-1))
