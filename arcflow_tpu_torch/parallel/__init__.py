"""Multi-device training and serving.

Counterparts in ``arcflow_tpu/parallel/mesh.py``: ``make_mesh`` (61-110;
the ``data`` and ``fsdp`` axes as a 2-D ``DeviceMesh``, or ``sp`` alone),
``batch_axes`` (165-172) and ``shard_model`` (``shard_state``, 210-240:
FSDP2 over ``fsdp``, replicated over ``data``); ``setup_distributed``
(31-58) and ``spawn`` start the ranks. The sequence-parallel (``sp``)
axis serves in its ring and Ulysses layouts
(``arcflow_tpu/parallel/ring_attention.py``)."""
from .fsdp import shard_model
from .launch import spawn
from .mesh import (SequenceParallel, batch_axes, make_mesh,
                   set_sequence_parallel, setup_distributed)
from .ring_attention import LocalRing, ring_attention, ring_partition

__all__ = ['LocalRing', 'SequenceParallel', 'batch_axes', 'make_mesh',
           'ring_attention', 'ring_partition', 'set_sequence_parallel',
           'setup_distributed', 'shard_model', 'spawn']
