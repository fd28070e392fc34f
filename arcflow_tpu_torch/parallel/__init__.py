"""Multi-device serving: the sequence-parallel (``sp``) axis in its ring and
Ulysses layouts, and a launcher for the ranks."""
from .launch import spawn
from .mesh import (SequenceParallel, make_mesh, set_sequence_parallel,
                   setup_distributed)
from .ring_attention import LocalRing, ring_attention, ring_partition

__all__ = ['LocalRing', 'SequenceParallel', 'make_mesh', 'ring_attention',
           'ring_partition', 'set_sequence_parallel', 'setup_distributed',
           'spawn']
