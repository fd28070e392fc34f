"""PyTorch + CUDA port of arcflow_tpu for NVIDIA Hopper (H100).

The JAX package ``arcflow_tpu`` is the reference; this package mirrors its
layout (``apis/``, ``data/``, ``diffusion/``, ``models/``, ``ops/``,
``parallel/``, ``pipelines/``, ``runner/``, ``ui/``, ``utils/``,
``config.py``, ``registry.py``; ``tools/`` and
``export_arcflow_to_diffusers.py`` for the repository root's scripts) and
names, imports ``torch`` and never ``jax``. Configs build through its
own registries, which the subpackage imports below fill. Its hand-written
kernels, one for every Pallas kernel of the JAX package, are the attention
forward and backward in ``csrc/attention_fwd.cu`` and
``csrc/attention_bwd.cu`` (``ops/attention.py``), the w4a8 grouped matmul
in ``csrc/w4a8_matmul.cu`` (``ops/quant_matmul.py``), the Gaussian-mixture
inverse CDF in ``csrc/gm_inverse_cdf.cu`` (``ops/gm/inverse_cdf.py``), the
ring-attention hop in ``csrc/ring_hop.cu`` (``ops/ring_hop.py``) and the
int8-QK^T flash attention in ``csrc/flash_int8.cu``
(``ops/flash_int8.py``); the warp-specialised ones share
``csrc/hopper.cuh``.
"""

from .config import Config, ConfigDict
from .registry import (DATASETS, HOOKS, MODELS, MODULES, SCHEDULERS,
                       build_model, build_module)

# importing the subpackages fills the registries, so a config builds right
# after ``import arcflow_tpu_torch`` in a fresh process
from . import diffusion  # noqa: E402,F401
from . import models     # noqa: E402,F401
from . import data       # noqa: E402,F401
from . import runner     # noqa: E402,F401

__all__ = ['Config', 'ConfigDict', 'DATASETS', 'HOOKS', 'MODELS', 'MODULES',
           'SCHEDULERS', 'build_model', 'build_module']
