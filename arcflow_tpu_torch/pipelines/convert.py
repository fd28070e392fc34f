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
* an RMSNorm or GroupNorm ``scale``, and a flax ``Embed``'s
  ``embedding`` (rows, features), become ``weight``;
* ``bias``, the LoRA leaves ``lora_a`` (in, r) / ``lora_b`` (r, out), the
  Wan RMSNorm ``gamma``, the int4 leaves of the JAX ``quant``
  collection, ``kernel_packed4`` (in/2, out) and ``kernel_scale4``
  (in/g, 1, out), and the MoE leaves under ``moe`` (raw parameters, not
  Dense kernels: ``router`` (D, E), ``w_in`` (E, D, F), ``b_in`` (E, F),
  ``w_out`` (E, F, D), ``b_out`` (E, D); a block stack's (L, E, ...)
  leaf loses its L axis to the ``ModuleList`` index) are kept as they
  are.

``load_jax_latent_diffusion`` carries a JAX ``LatentDiffusionTextImage``'s
(trainable, frozen) pair into the port's composition.

The diffusers-key half (counterpart of the JAX ``torch_flux_to_flax``,
``flax_to_torch_flux``, ``torch_vae_to_flax``, ``torch_qwen_vae_to_flax``,
``expand_proj_out_to_arc_heads``, ``fuse_lora``, ``fuse_pretrained_loras``
and ``graft_pretrained``) reads real checkpoints straight into the port's
``state_dict`` keys. A diffusers weight (out, in) is already the port's
layout, so only names change, except

* the peft LoRA leaves: ``lora_A.weight`` (r, in) -> ``lora_a`` (in, r),
  ``lora_B.weight`` (out, r) -> ``lora_b`` (r, out), with peft's
  ``.default.`` names accepted;
* the packed-token features: diffusers packs a latent patch as (c, p, p),
  the port (as JAX) as (p, p, c), so the ``x_embedder`` / ``img_in``
  inputs and the ``proj_out`` / ``proj_out_means`` outputs (the latter in
  K groups) are reordered (``_permute_packed``);
* the Wan VAE's causal 3-D kernels, of which the image mode keeps the last
  temporal slice.

Values keep their dtype. The key tables are the port's own copy of JAX
``pipelines/convert.py:26-107``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

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
    if name in ('scale', 'embedding'):
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
    ``PretrainedVAEQwenImage``, the UNets of ``models/unet.py``, the toy
    denoisers: ``ToyMLPDenoiser`` and
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
    overlaid with the ``diffusion`` adapter and, for a quantized trunk, the
    ``base_quant`` collection; the teacher's head from ``teacher_head``
    (its trunk is the student's), or the untied teacher from
    ``teacher_full`` with ``teacher_quant``. The port's composition must be
    quantized as the JAX one is (the same ``frozen_quant``). Values are cast
    to each tensor's storage dtype."""
    model.diffusion.denoising.load_state_dict(
        jax_params_to_torch(merge_params(frozen['base'],
                                         trainable['diffusion']),
                            frozen.get('base_quant')),
        strict=True)
    from ..models.latent_diffusion import TEACHER_HEAD_KEYS
    if model.teacher is None:
        return
    t_model = model.teacher.denoising
    if 'teacher_full' in frozen:
        t_model.load_state_dict(jax_params_to_torch(
            frozen['teacher_full'], frozen.get('teacher_quant')), strict=True)
        return
    head = nn.ModuleDict({k: getattr(t_model, k) for k in TEACHER_HEAD_KEYS})
    head.load_state_dict(jax_params_to_torch(frozen['teacher_head']),
                         strict=True)


# ---------------------------------------------------------------------------
# diffusers checkpoint keys -> the port's state_dict keys
# ---------------------------------------------------------------------------

# diffusers name -> port name, per FLUX block kind
_FLUX_JOINT_MAP = {
    'norm1.linear': 'img_norm1.modulation',
    'norm1_context.linear': 'txt_norm1.modulation',
    'attn.to_q': 'attn.img_q',
    'attn.to_k': 'attn.img_k',
    'attn.to_v': 'attn.img_v',
    'attn.to_out.0': 'attn.img_out',
    'attn.add_q_proj': 'attn.txt_q',
    'attn.add_k_proj': 'attn.txt_k',
    'attn.add_v_proj': 'attn.txt_v',
    'attn.to_add_out': 'attn.txt_out',
    'attn.norm_q': 'attn.img_q_norm',
    'attn.norm_k': 'attn.img_k_norm',
    'attn.norm_added_q': 'attn.txt_q_norm',
    'attn.norm_added_k': 'attn.txt_k_norm',
    'ff.net.0.proj': 'ff_img.in_proj',
    'ff.net.2': 'ff_img.out_proj',
    'ff_context.net.0.proj': 'ff_txt.in_proj',
    'ff_context.net.2': 'ff_txt.out_proj',
}
_FLUX_SINGLE_MAP = {
    'norm.linear': 'norm.modulation',
    'attn.to_q': 'attn.q',
    'attn.to_k': 'attn.k',
    'attn.to_v': 'attn.v',
    'attn.norm_q': 'attn.q_norm',
    'attn.norm_k': 'attn.k_norm',
    'proj_mlp': 'proj_mlp',
    'proj_out': 'proj_out',
}
_FLUX_TOP_MAP = {
    'x_embedder': 'x_embedder',
    'context_embedder': 'context_embedder',
    'time_text_embed.timestep_embedder.linear_1':
        'time_text_embed.timestep_embedder.linear1',
    'time_text_embed.timestep_embedder.linear_2':
        'time_text_embed.timestep_embedder.linear2',
    'time_text_embed.guidance_embedder.linear_1':
        'time_text_embed.guidance_embedder.linear1',
    'time_text_embed.guidance_embedder.linear_2':
        'time_text_embed.guidance_embedder.linear2',
    'time_text_embed.text_embedder.linear_1':
        'time_text_embed.text_embedder.linear1',
    'time_text_embed.text_embedder.linear_2':
        'time_text_embed.text_embedder.linear2',
    'norm_out.linear': 'norm_out.modulation',
    'proj_out': 'proj_out',
}
# Qwen-Image (diffusers transformer_qwenimage naming)
_QWEN_BLOCK_MAP = {
    'img_mod.1': 'img_norm1.modulation',
    'txt_mod.1': 'txt_norm1.modulation',
    'attn.to_q': 'attn.img_q',
    'attn.to_k': 'attn.img_k',
    'attn.to_v': 'attn.img_v',
    'attn.to_out.0': 'attn.img_out',
    'attn.add_q_proj': 'attn.txt_q',
    'attn.add_k_proj': 'attn.txt_k',
    'attn.add_v_proj': 'attn.txt_v',
    'attn.to_add_out': 'attn.txt_out',
    'attn.norm_q': 'attn.img_q_norm',
    'attn.norm_k': 'attn.img_k_norm',
    'attn.norm_added_q': 'attn.txt_q_norm',
    'attn.norm_added_k': 'attn.txt_k_norm',
    'img_mlp.net.0.proj': 'ff_img.in_proj',
    'img_mlp.net.2': 'ff_img.out_proj',
    'txt_mlp.net.0.proj': 'ff_txt.in_proj',
    'txt_mlp.net.2': 'ff_txt.out_proj',
}
_QWEN_TOP_MAP = {
    'img_in': 'img_in',
    'txt_in': 'txt_in',
    'txt_norm': 'txt_norm',
    'time_text_embed.timestep_embedder.linear_1':
        'timestep_embedder.linear1',
    'time_text_embed.timestep_embedder.linear_2':
        'timestep_embedder.linear2',
    'norm_out.linear': 'norm_out.modulation',
    'proj_out': 'proj_out',
}
# the ArcFlow heads keep their names
_ARC_HEAD_MAP = {k: k for k in ('proj_out_means', 'proj_out_logweights',
                                'proj_out_loggamma')}
# top-level layers whose weights touch the packed-token features:
# name -> ('in' | 'out', split in K groups)
_PACKED_TOUCHING = {
    'x_embedder': ('in', False),
    'img_in': ('in', False),
    'proj_out': ('out', False),
    'proj_out_means': ('out', True),
}
# diffusers leaf -> port leaf (the LoRA leaves are transposed)
_LEAVES = {'weight': 'weight', 'bias': 'bias', 'lora_A.weight': 'lora_a',
           'lora_B.weight': 'lora_b'}
_PORT_LEAVES = {v: k for k, v in _LEAVES.items()}

Tensor = torch.Tensor
State = Mapping[str, Union[Tensor, np.ndarray]]


def _tensor(v) -> Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


def _family_maps(family: str):
    """([(diffusers block prefix, port block prefix, map)], top map)."""
    if family == 'flux':
        return ([('transformer_blocks', 'joint_blocks', _FLUX_JOINT_MAP),
                 ('single_transformer_blocks', 'single_blocks',
                  _FLUX_SINGLE_MAP)], dict(_FLUX_TOP_MAP, **_ARC_HEAD_MAP))
    if family == 'qwen':
        return ([('transformer_blocks', 'transformer_blocks',
                  _QWEN_BLOCK_MAP)], dict(_QWEN_TOP_MAP, **_ARC_HEAD_MAP))
    raise ValueError(f'unknown family {family!r}: flux or qwen')


def _permute_packed(v: Tensor, axis: int, p2: int, groups: int = 1,
                    to_port: bool = True) -> Tensor:
    """Reorder a packed-token feature axis between diffusers' (g, c, p, p)
    and the port's (g, p, p, c) layout (JAX ``_permute_packed``); ``groups``
    are proj_out_means' K mixture components."""
    n = v.shape[axis]
    if p2 == 1 or n % (groups * p2) != 0:
        return v
    c = n // (groups * p2)
    v = v.movedim(axis, 0)
    rest = tuple(v.shape[1:])
    inner = (groups, c, p2) if to_port else (groups, p2, c)
    v = v.reshape(inner + rest).transpose(1, 2).reshape((n,) + rest)
    return v.movedim(0, axis).contiguous()


def _packed(name: str, leaf: str, v: Tensor, p2: int, k: Optional[int],
            to_port: bool) -> Tensor:
    if name not in _PACKED_TOUCHING or leaf not in ('weight', 'bias'):
        return v
    io, has_k = _PACKED_TOUCHING[name]
    groups = (k or 1) if has_k else 1
    if leaf == 'weight':        # (out, in): the packed side's axis
        return _permute_packed(v, 1 if io == 'in' else 0, p2, groups,
                               to_port)
    if io == 'out':             # a bias touches the packed output only
        return _permute_packed(v, 0, p2, groups, to_port)
    return v


def _lora_t(leaf: str, v: Tensor) -> Tensor:
    return v.t().contiguous() if leaf in ('lora_a', 'lora_b') else v


def _num_gaussians(state: Mapping, p2: int) -> Optional[int]:
    for leaf in ('.bias', '.weight'):
        v = state.get('proj_out_logweights' + leaf)
        if v is not None:
            return v.shape[0] // p2
    return None


def diffusers_to_torch(state: State, num_layers: int = 19,
                       num_single_layers: int = 38, family: str = 'flux',
                       patch_size: int = 2,
                       num_gaussians: Optional[int] = None
                       ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """A diffusers FLUX / Qwen-Image transformer state (plain weights, the
    ArcFlow heads, peft LoRA leaves) -> (the port's ``state_dict`` for
    ``ArcFluxTransformer2DModel`` / ``ArcQwenImageTransformer2DModel`` (or
    the teachers), the keys no map takes). Equal to
    ``jax_params_to_torch(torch_flux_to_flax(state, ...)[0])`` of the JAX
    package, key for key; a block key present for some blocks only
    raises, as there."""
    blocks, top = _family_maps(family)
    n_blocks = {'transformer_blocks': num_layers,
                'single_transformer_blocks': num_single_layers}
    p2 = patch_size * patch_size
    names = {}
    for key in state:
        names[re.sub(r'\.(lora_[AB])\.default\.weight$', r'.\1.weight',
                     key)] = key
    if num_gaussians is None:
        num_gaussians = _num_gaussians(
            {n: state[k] for n, k in names.items()}, p2)
    out: Dict[str, Tensor] = {}
    used = set()
    for t_prefix, p_prefix, mapping in blocks:
        n = n_blocks[t_prefix]
        for t_sub, p_sub in mapping.items():
            for leaf, p_leaf in _LEAVES.items():
                keys = [f'{t_prefix}.{i}.{t_sub}.{leaf}' for i in range(n)]
                present = [k in names for k in keys]
                if not any(present):
                    continue
                if not all(present):
                    raise KeyError(
                        f'{t_prefix}.*.{t_sub}.{leaf}: present for only '
                        f'{sum(present)}/{n} blocks')
                for i, k in enumerate(keys):
                    used.add(names[k])
                    out[f'{p_prefix}.{i}.{p_sub}.{p_leaf}'] = _lora_t(
                        p_leaf, _tensor(state[names[k]]))
    for t_sub, p_sub in top.items():
        for leaf, p_leaf in _LEAVES.items():
            k = f'{t_sub}.{leaf}'
            if k not in names:
                continue
            used.add(names[k])
            v = _packed(t_sub, p_leaf, _tensor(state[names[k]]), p2,
                        num_gaussians, to_port=True)
            out[f'{p_sub}.{p_leaf}'] = _lora_t(p_leaf, v)
    unused = {k: _tensor(v) for k, v in state.items() if k not in used}
    return out, unused


def torch_to_diffusers(state_dict: State, family: str = 'flux',
                       patch_size: int = 2,
                       num_gaussians: Optional[int] = None
                       ) -> Dict[str, Tensor]:
    """The inverse of ``diffusers_to_torch`` (JAX ``flax_to_torch_flux``):
    diffusers names and the (c, p, p) packed layout; keys of no map pass
    through as they are."""
    blocks, top = _family_maps(family)
    p2 = patch_size * patch_size
    if num_gaussians is None:
        num_gaussians = _num_gaussians(state_dict, p2)
    inverse = {}
    for t_prefix, p_prefix, mapping in blocks:
        for t_sub, p_sub in mapping.items():
            inverse[(p_prefix, p_sub)] = (t_prefix, t_sub)
    top_inverse = {p_sub: t_sub for t_sub, p_sub in top.items()}
    out: Dict[str, Tensor] = {}
    for key, v in state_dict.items():
        v = _tensor(v)
        path, _, leaf = key.rpartition('.')
        if leaf not in _PORT_LEAVES:
            out[key] = v
            continue
        head, _, rest = path.partition('.')
        index, _, sub = rest.partition('.')
        if index.isdigit() and (head, sub) in inverse:
            t_prefix, t_sub = inverse[(head, sub)]
            out[f'{t_prefix}.{index}.{t_sub}.{_PORT_LEAVES[leaf]}'] = \
                _lora_t(leaf, v)
        elif path in top_inverse:
            t_sub = top_inverse[path]
            v = _packed(t_sub, leaf, _lora_t(leaf, v), p2, num_gaussians,
                        to_port=False)
            out[f'{t_sub}.{_PORT_LEAVES[leaf]}'] = v
        else:
            out[key] = v
    return out


def expand_proj_out_to_arc_heads(state_dict: Mapping[str, Tensor],
                                 num_gaussians: int, patch_size: int = 2,
                                 noise: Optional[Tensor] = None,
                                 generator: Optional[torch.Generator] = None,
                                 noise_scale: float = 0.05
                                 ) -> Dict[str, Tensor]:
    """The student's means head from the teacher's ``proj_out`` (JAX
    ``expand_proj_out_to_arc_heads``): the (p, p, c) output rows tiled K
    times, the bias plus ``noise_scale`` x ``noise`` (K, C) standard normal
    draws shared over the p*p cells. ``noise`` defaults to draws from
    ``generator`` (a torch stream, not JAX's key 0: pass JAX's draws to
    reproduce its head). A state without ``proj_out`` comes back as it
    is."""
    out = dict(state_dict)
    if 'proj_out.weight' not in out:
        return out
    k, p2 = num_gaussians, patch_size * patch_size
    weight = out.pop('proj_out.weight')               # (p2 * C, D)
    bias = out.pop('proj_out.bias')
    c = weight.shape[0] // p2
    if noise is None:
        noise = torch.randn((k, c), generator=generator, dtype=torch.float32)
    noise = noise_scale * _tensor(noise).to(torch.float32).cpu()
    out['proj_out_means.weight'] = weight.reshape(1, p2, c, -1).expand(
        k, p2, c, weight.shape[1]).reshape(k * p2 * c, -1).contiguous()
    bias_k = bias.float().reshape(1, p2, c).expand(k, p2, c) \
        + noise.to(bias.device)[:, None, :]
    out['proj_out_means.bias'] = bias_k.reshape(-1).to(bias.dtype)
    return out


def fuse_lora(state_dict: Mapping[str, Tensor], scale: float = 1.0
              ) -> Dict[str, Tensor]:
    """Fold each layer's LoRA delta into its weight and drop the LoRA
    leaves (JAX ``fuse_lora``): W += scale (a b)^T, alpha = rank."""
    out = {}
    for key, v in state_dict.items():
        if key.endswith(('.lora_a', '.lora_b')):
            continue
        if key.endswith('.weight'):
            base = key[:-len('.weight')]
            a = state_dict.get(base + '.lora_a')
            b = state_dict.get(base + '.lora_b')
            if a is not None and b is not None:
                v = v + scale * (a @ b).t().to(v.dtype)
        out[key] = v
    return out


def fuse_pretrained_loras(state_dict: Mapping[str, Tensor],
                          lora_paths: Union[str, Sequence[str]],
                          lora_scales: Union[float, Sequence[float]] = 1.0,
                          family: str = 'flux') -> Dict[str, Tensor]:
    """Fold the LoRA deltas of each adapter file into the weights, each at
    its own scale, in order (JAX ``fuse_pretrained_loras``); an adapter's
    other keys are ignored."""
    from .loader import load_adapter_state
    paths = [lora_paths] if isinstance(lora_paths, str) else list(lora_paths)
    scales = [lora_scales] * len(paths) \
        if isinstance(lora_scales, (int, float)) else list(lora_scales)
    if len(scales) != len(paths):
        raise ValueError(f'{len(paths)} adapters, {len(scales)} scales')
    state = dict(state_dict)
    for path, scale in zip(paths, scales):
        adapter, _ = load_adapter_state(path, family=family)
        lora = {k: v for k, v in adapter.items()
                if k.endswith(('.lora_a', '.lora_b'))}
        state = fuse_lora({**state, **lora}, scale=float(scale))
    return state


def graft_pretrained(init_state: Mapping[str, Tensor],
                     converted: Mapping[str, Tensor],
                     strict_shapes: bool = True
                     ) -> Tuple[Dict[str, Tensor], list, list]:
    """Overlay converted weights on an init state, each cast to the init
    value's dtype: (state, missing keys, unexpected keys), the JAX
    ``graft_pretrained`` contract; a shape mismatch raises."""
    missing = [k for k in init_state if k not in converted]
    unexpected = [k for k in converted if k not in init_state]
    out = dict(init_state)
    for k, v in converted.items():
        if k not in out:
            continue
        if strict_shapes and tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f'shape mismatch for {k}: init '
                             f'{tuple(out[k].shape)} vs checkpoint '
                             f'{tuple(v.shape)}')
        out[k] = _tensor(v).to(out[k].dtype)
    return out, missing, unexpected


# diffusers AutoencoderKL (the FLUX VAE) -> models/vae.py names
_VAE_NAME_RULES = [
    (r'^(encoder|decoder)\.down_blocks\.(\d+)\.resnets\.(\d+)\.',
     r'\1.down_\2_res_\3.'),
    (r'^(encoder|decoder)\.up_blocks\.(\d+)\.resnets\.(\d+)\.',
     r'\1.up_\2_res_\3.'),
    (r'^(encoder|decoder)\.down_blocks\.(\d+)\.downsamplers\.0\.',
     r'\1.down_\2_ds.'),
    (r'^(encoder|decoder)\.up_blocks\.(\d+)\.upsamplers\.0\.',
     r'\1.up_\2_us.'),
    (r'\.mid_block\.resnets\.0\.', '.mid_res_1.'),
    (r'\.mid_block\.resnets\.1\.', '.mid_res_2.'),
    (r'\.mid_block\.attentions\.0\.', '.mid_attn.'),
    (r'\.to_out\.0\.', '.to_out.'),
]
# diffusers AutoencoderKLQwenImage / AutoencoderKLWan -> models/qwen_vae.py
_QWEN_VAE_NAME_RULES = [
    (r'^encoder\.down_blocks\.(\d+)\.', r'encoder.down_blocks_\1.'),
    (r'^decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.',
     r'decoder.up_blocks_\1.resnets_\2.'),
    (r'^decoder\.up_blocks\.(\d+)\.upsamplers\.0\.',
     r'decoder.up_blocks_\1.upsampler.'),
    (r'\.mid_block\.resnets\.(\d+)\.', r'.mid_block.resnets_\1.'),
    (r'\.mid_block\.attentions\.0\.', '.mid_block.attentions_0.'),
    (r'\.resample\.1\.', '.resample_conv.'),
]
# the decoder half of a VAE, and the encoder half
_DECODER_PREFIXES = ('decoder.', 'post_quant_conv.')
_ENCODER_PREFIXES = ('encoder.', 'quant_conv.')


def _vae_prefixes(encoder: bool):
    return _DECODER_PREFIXES + (_ENCODER_PREFIXES if encoder else ())


def _rename(key: str, rules) -> str:
    for pat, rep in rules:
        key = re.sub(pat, rep, key)
    return key


def diffusers_vae_to_torch(state: State, encoder: bool = False
                           ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """A diffusers AutoencoderKL state -> (the port's ``PretrainedVAE``
    keys, the rest): JAX ``torch_vae_to_flax``, values as they are (conv
    (o, i, h, w), linear (out, in) and GroupNorm weights are the port's
    layout). The decoder half always; the encoder and ``quant_conv`` with
    ``encoder``, else they come back unused."""
    prefixes = _vae_prefixes(encoder)
    out, unused = {}, {}
    for key, v in state.items():
        v = _tensor(v)
        leaf = key.rpartition('.')[2]
        if key.startswith(prefixes) and (
                leaf == 'bias' or leaf == 'weight' and (
                    v.ndim in (2, 4) or _is_vae_norm(key))):
            out[_rename(key, _VAE_NAME_RULES)] = v
        else:
            unused[key] = v
    return out, unused


def _is_vae_norm(key: str) -> bool:
    module = key.rpartition('.')[0].rpartition('.')[2]
    return module in ('norm1', 'norm2', 'group_norm', 'conv_norm_out',
                      'norm_out')


def diffusers_qwen_vae_to_torch(state: State, encoder: bool = False
                                ) -> Tuple[Dict[str, Tensor],
                                           Dict[str, Tensor]]:
    """A diffusers AutoencoderKLQwenImage (Wan 3-D causal) state -> (the
    port's ``PretrainedVAEQwenImage`` keys, the rest): JAX
    ``torch_qwen_vae_to_flax``. A causal 3-D kernel (o, i, t, h, w) keeps
    its last temporal slice (on one frame the causal padding shows the
    earlier slices only zeros), ``time_conv`` weights are skipped (never
    applied to a first frame) and the Wan RMSNorm gamma flattens to (c,).
    The decoder half always; the encoder and ``quant_conv`` with
    ``encoder``, else they come back unused."""
    prefixes = _vae_prefixes(encoder)
    out, unused = {}, {}
    for key, v in state.items():
        v = _tensor(v)
        leaf = key.rpartition('.')[2]
        if '.time_conv.' in key and key.startswith(prefixes):
            continue
        if not key.startswith(prefixes) or \
                leaf not in ('gamma', 'weight', 'bias'):
            unused[key] = v
            continue
        if leaf == 'gamma':
            v = v.reshape(-1)
        elif leaf == 'weight' and v.ndim == 5:
            v = v[:, :, -1].contiguous()
        elif leaf == 'weight' and v.ndim != 4:
            unused[key] = v
            continue
        out[_rename(key, _QWEN_VAE_NAME_RULES)] = v
    return out, unused


def load_safetensors_state(path: str) -> Dict[str, Tensor]:
    """A ``.safetensors`` file, a sharded ``*.safetensors.index.json`` or a
    folder of either -> {key: tensor} on the CPU, in the stored dtype
    (bf16 stays bf16). ``path`` may be a remote URI (``utils/io_utils``):
    a remote folder is probed for the diffusers file names, sharded index
    first, and each file is read through ``io_utils.local_file`` (JAX
    ``convert.py:201-231`` reads only backends with a local cache, the hub;
    the port fetches the bytes of any backend)."""
    from safetensors.torch import load_file

    from ..utils.io_utils import get_file_backend, local_file, uri_scheme
    if uri_scheme(path) != 'local':
        backend = get_file_backend(path)
        if not path.endswith(('.safetensors', '.index.json')):
            for name in REMOTE_WEIGHT_NAMES:
                if backend.exists(backend.join_path(path, name)):
                    path = backend.join_path(path, name)
                    break
            else:
                raise FileNotFoundError(
                    f'no safetensors checkpoint found under {path}')
        if path.endswith('.index.json'):
            with local_file(path, suffix='.json') as local, \
                    open(local) as f:
                index = json.load(f)
            base = path.rsplit('/', 1)[0]
            files = [f'{base}/{shard}'
                     for shard in sorted(set(index['weight_map'].values()))]
        else:
            files = [path]
        state = {}
        for f in files:
            with local_file(f, suffix='.safetensors') as local:
                state.update(load_file(local))
        return state
    if os.path.isdir(path):
        index = sorted(f for f in os.listdir(path)
                       if f.endswith('.safetensors.index.json'))
        if index:
            return load_safetensors_state(os.path.join(path, index[0]))
        files = sorted(f for f in os.listdir(path)
                       if f.endswith('.safetensors'))
        if not files:
            raise FileNotFoundError(f'no safetensors checkpoint in {path}')
        state = {}
        for f in files:
            state.update(load_file(os.path.join(path, f)))
        return state
    if path.endswith('.index.json'):
        with open(path) as f:
            index = json.load(f)
        base = os.path.dirname(path)
        state = {}
        for shard in sorted(set(index['weight_map'].values())):
            state.update(load_file(os.path.join(base, shard)))
        return state
    return load_file(path)


# the file names a remote model folder is probed for, in order (JAX
# ``convert.py:214-217``)
REMOTE_WEIGHT_NAMES = ('diffusion_pytorch_model.safetensors.index.json',
                       'model.safetensors.index.json',
                       'diffusion_pytorch_model.safetensors',
                       'model.safetensors')
