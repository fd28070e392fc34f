"""PyTorch + CUDA port of arcflow_tpu for NVIDIA Hopper (H100).

The JAX package ``arcflow_tpu`` is the reference; this package mirrors its
layout (``data/``, ``diffusion/``, ``models/``, ``ops/``, ``parallel/``,
``pipelines/``, ``runner/``)
and names, imports ``torch`` and never ``jax``. Its hand-written kernels,
one for every Pallas kernel of the JAX package, are the attention forward
and backward in ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``
(``ops/attention.py``), the w4a8 grouped matmul in ``csrc/w4a8_matmul.cu``
(``ops/quant_matmul.py``), the Gaussian-mixture inverse CDF in
``csrc/gm_inverse_cdf.cu`` (``ops/gm/inverse_cdf.py``), the ring-attention
hop in ``csrc/ring_hop.cu`` (``ops/ring_hop.py``) and the int8-QK^T flash
attention in ``csrc/flash_int8.cu`` (``ops/flash_int8.py``); the
warp-specialised ones share ``csrc/hopper.cuh``.
"""
