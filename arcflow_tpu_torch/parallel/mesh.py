"""Process groups and the sequence-parallel (``sp``) state.

Counterpart of the ``sp`` part of ``arcflow_tpu/parallel/mesh.py``:
``setup_distributed`` (its lines 31-58) starts the process group,
``make_mesh`` (61-110) takes only the ``sp`` axis, and one explicit
``SequenceParallel`` object, held by the transformer's attention modules and
its trunk, replaces the process-global activation state ``_ACT`` (245-306).
Its helpers cut the tokens into this rank's shard and gather them back
(JAX ``shard_activation('residual')``), and move attention between token
shards and head shards for the Ulysses layout (JAX ``heads_partition``,
379-405). The ``data``, ``fsdp``, ``tensor``, ``pipe`` and ``expert`` axes
wait for their slices (ROADMAP A12).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

SP_MODES = ('ring', 'ulysses')


def setup_distributed(device: Optional[str] = None, timeout: float = 600.0
                      ) -> torch.device:
    """Start the default process group from ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK`` (the variables
    ``parallel/launch.py:spawn`` and ``torchrun`` set) and return this
    rank's device: NCCL on ``cuda:{LOCAL_RANK}``, or gloo on the CPU when
    ``device='cpu'``. Without a CUDA device and without ``device='cpu'`` it
    raises. ``timeout`` (seconds) bounds every collective."""
    rank = int(os.environ['RANK'])
    world = int(os.environ['WORLD_SIZE'])
    if device == 'cpu':
        backend, dev = 'gloo', torch.device('cpu')
    elif device is None or device == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" to run the '
                               'ranks on the CPU over gloo')
        backend = 'nccl'
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', rank)))
        torch.cuda.set_device(dev)
    else:
        raise ValueError(f'device must be "cuda" or "cpu", got {device!r}')
    dist.init_process_group(backend, init_method='env://', rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout))
    return dev


def make_mesh(axes: Dict[str, int]) -> Dict[str, Optional[dist.ProcessGroup]]:
    """{'sp': n} -> {'sp': the process group of the n ranks}. The axis must
    span every process (-1 takes them all); a one-process ``sp`` of 1 has
    no group. Any other axis raises."""
    other = sorted(set(axes) - {'sp'})
    if other:
        raise NotImplementedError(f'mesh axes {other} are not ported yet '
                                  f'(ROADMAP A12); only sp is')
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = axes.get('sp', 1)
    n = world if n == -1 else n
    if n != world:
        raise ValueError(f'sp={n} must span every process ({world}); start '
                         f'them with setup_distributed')
    return {'sp': dist.group.WORLD if dist.is_initialized() else None}


class SequenceParallel:
    """This rank's place in a sequence-parallel group and the layout of
    attention over it (``mode``): 'ring' keeps the sequence cut inside
    attention and rotates K/V blocks (``parallel/ring_attention.py``);
    'ulysses' trades the token shard for a head shard of the full sequence
    with one all-to-all on each side of the attention kernel."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None,
                 mode: str = 'ulysses'):
        if mode not in SP_MODES:
            raise ValueError(f'sp_mode must be one of {SP_MODES}, got '
                             f'{mode!r}')
        self.group = group or dist.group.WORLD
        self.mode = mode
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's contiguous slice of ``x`` along ``dim``."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f'{n} tokens do not split over {self.size} '
                             f'ranks')
        return x.narrow(dim, self.rank * (n // self.size), n // self.size)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        if x.dtype == torch.bool:
            return self.gather(x.to(torch.uint8), dim).bool()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def seq_to_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S/n, H, D) token shard -> (B, S, H/n, D) head shard, the
        tokens in rank order (one all-to-all)."""
        b, s, h, d = x.shape
        n = self.size
        if h % n:
            raise ValueError(f'Ulysses needs heads % sp == 0, got {h} heads '
                             f'over {n} ranks: use sp_mode="ring"')
        send = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
        recv = torch.empty_like(send, memory_format=torch.contiguous_format)
        dist.all_to_all_single(recv, send.contiguous(), group=self.group)
        return recv.transpose(0, 1).reshape(b, n * s, h // n, d)

    def heads_to_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of ``seq_to_heads``: (B, S, H/n, D) -> (B, S/n, H,
        D)."""
        b, s_all, hn, d = x.shape
        n = self.size
        send = x.reshape(b, n, s_all // n, hn, d).transpose(0, 1)
        recv = torch.empty_like(send, memory_format=torch.contiguous_format)
        dist.all_to_all_single(recv, send.contiguous(), group=self.group)
        return recv.permute(1, 2, 0, 3, 4).reshape(b, s_all // n, n * hn, d)


def stream_padding(sp, *lengths: int):
    """The zero tokens to append to each stream of ``lengths`` tokens so
    that the sequence-parallel state ``sp`` (a ``SequenceParallel``, a
    ``LocalRing`` or None) cuts it into equal shards: 0 without ``sp`` or
    where ``sp.size`` divides the length. The JAX package leaves such a
    stream replicated instead (``arcflow_tpu/parallel/mesh.py:459-460``);
    padded keys are masked and padded rows dropped, so the result is the
    same."""
    size = 1 if sp is None else sp.size
    return [-n % size for n in lengths]


def pad_tokens(x: torch.Tensor, pad: int, dim: int = 1) -> torch.Tensor:
    """``x`` with ``pad`` zero tokens appended along ``dim``."""
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def token_validity(x: torch.Tensor, pad: int,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N + pad) bool validity of the tokens of ``x`` (B, N, ...):
    ``valid`` (every token when None), then ``pad`` invalid ones."""
    if valid is None:
        valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    return pad_tokens(valid.bool(), pad)


def set_sequence_parallel(module: nn.Module, sp) -> None:
    """Give ``module`` and each of its submodules that holds sequence-
    parallel state (the trunks and their attention modules) ``sp``: a
    ``SequenceParallel``, a ``LocalRing`` or None (one device)."""
    for m in module.modules():
        if hasattr(m, 'sequence_parallel'):
            m.sequence_parallel = sp
