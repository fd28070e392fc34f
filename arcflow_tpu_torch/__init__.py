"""PyTorch + CUDA port of arcflow_tpu for NVIDIA Hopper (H100).

The JAX package ``arcflow_tpu`` is the reference; this package mirrors its
layout (``diffusion/``, ``models/``, ``ops/``, ``pipelines/``) and names,
imports ``torch`` and never ``jax``. Its one hand-written kernel so far is
the attention forward in ``csrc/attention_fwd.cu`` (``ops/attention.py``).
"""
