"""PyTorch + CUDA port of arcflow_tpu for NVIDIA Hopper (H100).

The JAX package ``arcflow_tpu`` is the reference; this package mirrors its
layout (``diffusion/``, ``models/``, ``ops/``, ``pipelines/``, ``runner/``)
and names, imports ``torch`` and never ``jax``. Its hand-written kernels so
far are the attention forward and backward in ``csrc/attention_fwd.cu`` and
``csrc/attention_bwd.cu`` (``ops/attention.py``) and the w4a8 grouped
matmul in ``csrc/w4a8_matmul.cu`` (``ops/quant_matmul.py``).
"""
