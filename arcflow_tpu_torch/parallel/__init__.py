"""Multi-device training and serving.

Counterparts in ``arcflow_tpu/parallel/mesh.py``: ``make_mesh`` (61-110;
the ``data`` and ``fsdp`` axes as a 2-D ``DeviceMesh``, or ``sp`` alone),
``batch_axes`` (165-172) and ``shard_model`` (``shard_state``, 210-240:
FSDP2 over ``fsdp``, replicated over ``data``); ``setup_distributed``
(31-58) and ``spawn`` start the ranks. The sequence-parallel (``sp``)
axis serves in its ring and Ulysses layouts
(``arcflow_tpu/parallel/ring_attention.py``). The ``pipe`` axis runs the
block stacks as pipelines (``pipeline.py``, JAX ``parallel/pipeline.py``)
and the ``expert`` axis splits the MoE experts (``expert.py``);
``model_parallel.py`` places a model on both. The ``tensor`` axis splits
the blocks Megatron-style (``tensor.py``: ``LocalTensor`` in one process,
``TensorGroup`` over the mesh's tensor group)."""
from .fsdp import shard_model
from .expert import ExpertParallel
from .launch import spawn
from .mesh import (SequenceParallel, batch_axes, make_mesh,
                   set_sequence_parallel, setup_distributed)
from .model_parallel import partition_model
from .pipeline import LocalPipe, PipeGroup, pipeline_run, set_pipe
from .ring_attention import LocalRing, ring_attention, ring_partition
from .tensor import (LocalTensor, TensorGroup, partition_tensor,
                     set_tensor_parallel)

__all__ = ['ExpertParallel', 'LocalPipe', 'LocalRing', 'LocalTensor',
           'PipeGroup', 'SequenceParallel', 'TensorGroup', 'batch_axes',
           'make_mesh', 'partition_model', 'partition_tensor',
           'pipeline_run', 'ring_attention', 'ring_partition', 'set_pipe',
           'set_sequence_parallel', 'set_tensor_parallel',
           'setup_distributed', 'shard_model', 'spawn']
