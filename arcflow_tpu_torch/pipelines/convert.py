"""Carry the JAX package's parameter trees over to the port's modules.

The port names its modules after the JAX param tree, so the map is
mechanical (compare ``arcflow_tpu/pipelines/convert.py:flax_to_torch_flux``,
which does the same unstacking for diffusers naming):

* ``joint_blocks`` / ``single_blocks`` / ``transformer_blocks`` are
  ``nn.scan`` stacks in JAX: their axis 0 becomes the ``nn.ModuleList``
  index;
* a 2-D float ``kernel`` (in, out) becomes ``weight`` (out, in); a conv
  ``kernel`` (kh, kw, in, out) becomes ``weight`` (out, in, kh, kw);
* an int8 ``kernel`` (in, out) of ``quantize_weights_int8`` stays
  ``kernel``, and its ``kernel_scale`` (1, out) from the ``quant``
  collection stays as it is, for a module quantized by the port's
  ``quantize_weights_int8`` (whose int8 ``kernel`` buffer has that shape);
* an RMSNorm or GroupNorm ``scale`` becomes ``weight``;
* ``bias``, the LoRA leaves ``lora_a`` (in, r) / ``lora_b`` (r, out), the
  Wan RMSNorm ``gamma`` and the int4 leaves of the JAX ``quant``
  collection, ``kernel_packed4`` (in/2, out) and ``kernel_scale4``
  (in/g, 1, out), are kept as they are.

``load_jax_latent_diffusion`` carries a JAX ``LatentDiffusionTextImage``'s
(trainable, frozen) pair into the port's composition. A loader for
diffusers checkpoint keys comes with ``from_pretrained``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..utils.pytree import merge_params

STACKED = ('joint_blocks', 'single_blocks', 'transformer_blocks')


def _flatten(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f'{prefix}{k}'
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + '.'))
        else:
            out[key] = np.asarray(v)
    return out


def _leaf(name: str, v: np.ndarray):
    if name == 'kernel' and v.dtype == np.int8:
        if v.ndim != 2:
            raise ValueError(f'unexpected int8 kernel rank {v.ndim}')
        return name, v
    if name == 'kernel':
        if v.ndim == 2:
            return 'weight', v.T
        if v.ndim == 4:
            return 'weight', v.transpose(3, 2, 0, 1)
        raise ValueError(f'unexpected kernel rank {v.ndim}')
    if name == 'scale':
        return 'weight', v
    return name, v


def jax_params_to_torch(tree: Mapping, quant: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of numpy arrays, e.g. from
    ``jax.device_get``), and the ``quant`` collection of an int8- or
    int4-quantized model if there is one, -> ``state_dict`` for the port's
    module of the same structure (``ArcFluxTransformer2DModel``,
    ``ArcQwenImageTransformer2DModel`` (after ``quantize_weights_int8`` or
    ``quantize_weights_int4`` when ``quant`` is given), ``PretrainedVAE``,
    ``PretrainedVAEQwenImage``, the toy denoisers: ``ToyMLPDenoiser`` and
    ``ToyArcFlowDenoiser``'s rank-0 ``LoRADense_i`` trunks map as any
    dense layer)."""
    out = {}
    for key, v in {**_flatten(tree), **_flatten(quant or {})}.items():
        *path, name = key.split('.')
        if path and path[0] in STACKED:
            for i in range(v.shape[0]):
                t_name, t_v = _leaf(name, v[i])
                out['.'.join([path[0], str(i), *path[1:], t_name])] = t_v
        else:
            t_name, t_v = _leaf(name, v)
            out['.'.join([*path, t_name])] = t_v
    return {k: torch.from_numpy(np.array(v, order='C'))
            for k, v in out.items()}


def load_jax_latent_diffusion(model, trainable: Mapping, frozen: Mapping):
    """Load the (trainable, frozen) pair of the JAX
    ``LatentDiffusionTextImage.init_params`` into the port's composition,
    each part with ``strict=True``: the student from the frozen ``base``
    overlaid with the ``diffusion`` adapter, and the teacher's head from
    ``teacher_head`` (its trunk is the student's). Values are cast to each
    parameter's storage dtype."""
    model.diffusion.denoising.load_state_dict(
        jax_params_to_torch(merge_params(frozen['base'],
                                         trainable['diffusion'])),
        strict=True)
    from ..models.latent_diffusion import TEACHER_HEAD_KEYS
    if model.teacher is not None:
        t_model = model.teacher.denoising
        head = nn.ModuleDict({k: getattr(t_model, k)
                              for k in TEACHER_HEAD_KEYS})
        head.load_state_dict(jax_params_to_torch(frozen['teacher_head']),
                             strict=True)
