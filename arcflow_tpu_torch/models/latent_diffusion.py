"""Latent text-to-image distillation composition: the student, its frozen
trunk shared with the teacher, the VAE and text encoders, the distillation
loss and sampling.

Counterpart of ``arcflow_tpu/models/latent_diffusion.py:LatentDiffusionTextImage``
and its weight economy:

* the student's adapter (``ARCFLUX_ADAPTER_KEYS``: the three heads,
  ``norm_out`` and every LoRA leaf) is trainable and stored in fp32;
* the rest of the student is the frozen trunk, stored in ``frozen_dtype``
  (fp32 when None, as the JAX ``param_dtype``) and, with ``frozen_quant``
  ('int8' or 'int4'), quantized weight-only once at init through
  ``utils/quantize.py`` (the JAX skip rules, ``frozen_quant_min_size``
  counted over a block stack as JAX counts its scanned stacks);
* the tied teacher has its own frozen head (``TEACHER_HEAD_KEYS``); its
  trunk IS the student's trunk modules, quantized buffers included, run
  with their LoRA off (``lora_disabled``), so the trunk is in memory once
  (the JAX dict overlay, ``latent_diffusion.py:256-273``). With
  ``tie_teacher=False`` the teacher is whole and its own
  (``frozen['teacher_full']``), quantized on its own.

Configs are the JAX package's dicts, built through ``MODULES``: the
student on ``device`` (the card unless the caller says otherwise), the tied
teacher on the meta device but for its head, as it takes the student's
trunk modules; both compute in ``dtype``. ``pretrained`` /
``pretrained_adapter`` on the student's denoising config and
``pretrained`` / ``pretrained_lora`` /
``pretrained_lora_scale`` on the teacher's load diffusers-key checkpoints
at construction (the JAX package loads them in ``init_params``; the port's
modules hold their weights). The K-way means head's bias noise comes from
torch's global generator. Latents come from the batch or from
``images`` through ``vae.encode``, prompt embeds from the batch or from
``prompt_kwargs`` through ``text_encoder``. Latents of any height and
width train, as in JAX (one resolution bucket per batch), and are checked
against ``latent_shape``'s channels only; ``latent_shape`` itself sizes
``val_step``'s noise. Prompt embeds are checked against
``text_embed_dim``, ``pooled_dim`` (FLUX only: Qwen has no pooled
projections) and ``max_text_len``. Qwen's
``encoder_hidden_states_mask`` reaches the attention kernels as their key
mask, and Qwen's denoisers get no distilled ``guidance`` (they have no
guidance embeds; the JAX modules swallow it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..diffusion.arcflow import multistep_train_loss
from ..registry import MODELS, MODULES
from ..utils.pytree import name_matches
from .base import BaseModel, swapped_params
from .flux import ARCFLUX_ADAPTER_KEYS
from .layers import lora_disabled

# the teacher's own head; the rest of it is the student's frozen trunk
TEACHER_HEAD_KEYS = ('proj_out', 'norm_out')


def _share_trunk(teacher: nn.Module, student: nn.Module):
    """Make the tied teacher's trunk the student's own modules (its head,
    ``TEACHER_HEAD_KEYS``, stays its own): the trunk is in memory once,
    quantized or not, and sharding the student shards it for both. Each
    teacher child must have a student twin of the same module types and
    parameter shapes (a quantized twin holds no ``weight``); the teacher
    runs them under ``lora_disabled``."""
    def kinds(m):
        return [(n, type(x)) for n, x in m.named_modules()]
    for name, child in list(teacher.named_children()):
        if name in TEACHER_HEAD_KEYS:
            continue
        twin = getattr(student, name, None)
        ok = isinstance(twin, nn.Module) and kinds(twin) == kinds(child)
        if ok:
            shapes = {n: p.shape for n, p in twin.named_parameters()}
            ok = all(shapes.get(n, p.shape) == p.shape
                     for n, p in child.named_parameters())
        if not ok:
            raise ValueError(f'teacher module {name} has no frozen student '
                             f'twin')
        setattr(teacher, name, twin)


def _pop_pretrained(cfg: Optional[dict], *keys):
    """(cfg without ``keys`` in its denoising config, their values)."""
    if not cfg:
        return cfg, [None] * len(keys)
    cfg = dict(cfg)
    den = dict(cfg.get('denoising') or {})
    values = [den.pop(k, None) for k in keys]
    if cfg.get('denoising'):
        cfg['denoising'] = den
    return cfg, values


@MODELS.register_module()
class LatentDiffusionTextImage(BaseModel):

    def __init__(self, diffusion: dict, teacher: Optional[dict] = None,
                 vae: Optional[dict] = None,
                 text_encoder: Optional[dict] = None,
                 diffusion_use_ema: bool = True, tie_teacher: bool = True,
                 latent_shape: Tuple[int, int, int] = (64, 64, 16),
                 text_embed_dim: int = 4096, pooled_dim: int = 768,
                 max_text_len: int = 512,
                 frozen_dtype: Union[None, str, torch.dtype] = None,
                 frozen_quant: Optional[str] = None,
                 frozen_quant_min_size: int = 2 ** 16,
                 frozen_quant_group_size: int = 128,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, device='cuda',
                 dtype: Union[str, torch.dtype] = torch.bfloat16):
        super().__init__(train_cfg, test_cfg)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        if frozen_quant not in (None, 'int8', 'int4'):
            raise ValueError(f'frozen_quant {frozen_quant!r}: want None, '
                             f'int8 or int4')
        if isinstance(frozen_dtype, str):
            frozen_dtype = getattr(torch, frozen_dtype)
        self.frozen_dtype = frozen_dtype or torch.float32
        self.frozen_quant = frozen_quant
        self.frozen_quant_min_size = frozen_quant_min_size
        self.frozen_quant_group_size = frozen_quant_group_size
        self.device = torch.device(device)
        self.diffusion_use_ema = diffusion_use_ema
        self.tie_teacher = tie_teacher
        self.latent_shape = tuple(latent_shape)
        self.text_embed_dim = text_embed_dim
        self.pooled_dim = pooled_dim
        self.max_text_len = max_text_len

        diffusion, (self.pretrained, self.pretrained_adapter) = \
            _pop_pretrained(diffusion, 'pretrained', 'pretrained_adapter')
        teacher, (t_pretrained, self.teacher_pretrained_lora,
                  t_lora_scale) = _pop_pretrained(
            teacher, 'pretrained', 'pretrained_lora', 'pretrained_lora_scale')
        self.teacher_pretrained = (t_pretrained or self.pretrained) \
            if teacher else None
        self.teacher_pretrained_lora_scale = 1.0 if t_lora_scale is None \
            else t_lora_scale

        self.diffusion = MODULES.build(diffusion, default_args=dict(
            train_cfg=self.train_cfg, test_cfg=self.test_cfg, device=device,
            dtype=dtype))
        student = self.diffusion.denoising
        self.family = student.family
        self._adapter = set()
        for name, p in student.named_parameters():
            if name_matches(name, ARCFLUX_ADAPTER_KEYS):
                p.data = p.data.float()
                p.requires_grad_(True)
                self._adapter.add(name)
            else:
                p.data = p.data.to(self.frozen_dtype)
                p.requires_grad_(False)
        converted = None
        if self.pretrained is not None:
            converted = self._load_student(student)
        self._quantize(student)

        self.teacher = None
        if teacher:
            self._build_teacher(teacher, converted, device, dtype)
        self.vae = MODULES.build(vae, default_args=dict(device=device)) \
            if vae else None
        self.text_encoder = MODULES.build(
            text_encoder, default_args=dict(device=device)) \
            if text_encoder else None

    # ---- weights ---------------------------------------------------------------
    def _quantize(self, module: nn.Module):
        """Weight-only int8 / int4 on ``module``'s frozen kernels, as JAX
        quantizes ``frozen['base']`` / ``frozen['teacher_full']``."""
        if self.frozen_quant is None:
            return
        from ..utils import quantize
        if self.frozen_quant == 'int8':
            quantize.quantize_weights_int8(
                module, min_size=self.frozen_quant_min_size)
        else:
            quantize.quantize_weights_int4(
                module, min_size=self.frozen_quant_min_size,
                group_size=self.frozen_quant_group_size)

    def _convert(self, path: str, module: nn.Module) -> Dict[str, torch.Tensor]:
        """A diffusers-key checkpoint in the port's keys for ``module``'s
        family; keys of no map other than the VAE's, text encoders' and
        scheduler's raise (JAX ``_load_pretrained_tree``)."""
        from ..pipelines.convert import (diffusers_to_torch,
                                         load_safetensors_state)
        flux = self.family == 'flux'
        converted, unused = diffusers_to_torch(
            load_safetensors_state(path),
            num_layers=len(module.joint_blocks if flux
                           else module.transformer_blocks),
            num_single_layers=len(module.single_blocks) if flux else 0,
            family=self.family, patch_size=module.patch_size,
            num_gaussians=getattr(module, 'num_gaussians', None))
        unexpected = [k for k in unused if not k.startswith(
            ('vae.', 'text_encoder', 'scheduler'))]
        if unexpected:
            raise ValueError(f'{len(unexpected)} unconvertible checkpoint '
                             f'keys, e.g. {sorted(unexpected)[:5]}')
        return converted

    def _fuse_teacher_loras(self, converted):
        from ..pipelines.convert import fuse_pretrained_loras
        return fuse_pretrained_loras(
            converted, self.teacher_pretrained_lora,
            self.teacher_pretrained_lora_scale, family=self.family)

    @staticmethod
    def _graft(module: nn.Module, converted, what: str):
        """Load ``converted`` over ``module``'s own tensors, each cast to
        its storage dtype; a key the module lacks raises."""
        from ..pipelines.convert import graft_pretrained
        state, _, unexpected = graft_pretrained(module.state_dict(),
                                                converted)
        if unexpected:
            raise ValueError(f'pretrained keys not in the {what}: '
                             f'{sorted(unexpected)[:5]}')
        module.load_state_dict(state, strict=True)

    def _load_student(self, student: nn.Module) -> Dict[str, torch.Tensor]:
        """JAX ``init_params``' student half: the checkpoint (with the tied
        teacher's LoRAs fused when both load the same file), its
        ``proj_out`` expanded to the K-way means head, then
        ``pretrained_adapter``'s LoRA fused into the base and its other
        keys merged, the student's fresh LoRA kept. Returns the converted
        checkpoint for the teacher."""
        from ..pipelines.convert import expand_proj_out_to_arc_heads, fuse_lora
        converted = self._convert(self.pretrained, student)
        if (self.teacher_pretrained_lora is not None and self.tie_teacher
                and self.teacher_pretrained == self.pretrained):
            converted = self._fuse_teacher_loras(converted)
        self._graft(student, expand_proj_out_to_arc_heads(
            converted, num_gaussians=student.num_gaussians,
            patch_size=student.patch_size), 'student')
        if self.pretrained_adapter is not None:
            from ..pipelines.loader import load_adapter_state
            adapter, _ = load_adapter_state(self.pretrained_adapter,
                                            family=self.family)
            adapter = {k: v.to(self.device) for k, v in adapter.items()}
            state = student.state_dict()
            fused = fuse_lora({**state, **adapter})
            fresh = {k: v for k, v in state.items() if 'lora' in k}
            student.load_state_dict({**fused, **fresh}, strict=True)
        return converted

    def _build_teacher(self, teacher: dict, converted, device, dtype):
        if self.tie_teacher:
            # the trunk without storage: the student's replaces it below
            self.teacher = MODULES.build(teacher, default_args=dict(
                device='meta', dtype=dtype))
            t_model = self.teacher.denoising
            t_model.init_head(device=device, dtype=dtype)
        else:
            self.teacher = MODULES.build(teacher, default_args=dict(
                device=device, dtype=dtype))
            t_model = self.teacher.denoising
        for p in t_model.parameters():
            if p.device.type != 'meta':
                p.data = p.data.to(self.frozen_dtype)
            p.requires_grad_(False)
        if self.teacher_pretrained is not None:
            t_converted = converted if (
                converted is not None
                and self.teacher_pretrained == self.pretrained) \
                else self._convert(self.teacher_pretrained, t_model)
            if self.teacher_pretrained_lora is not None and not (
                    self.tie_teacher and t_converted is converted):
                t_converted = self._fuse_teacher_loras(t_converted)
            if self.tie_teacher:
                t_converted = {k: v for k, v in t_converted.items()
                               if name_matches(k, TEACHER_HEAD_KEYS,
                                               exact_prefix=True)}
                head = nn.ModuleDict({k: getattr(t_model, k)
                                      for k in TEACHER_HEAD_KEYS})
                self._graft(head, t_converted, 'teacher head')
            else:
                self._graft(t_model, t_converted, 'teacher')
        if not self.tie_teacher:
            self._quantize(t_model)
            return
        _share_trunk(t_model, self.diffusion.denoising)

    @property
    def ema_keys(self):
        return ('diffusion',) if self.diffusion_use_ema else ()

    def init_params(self):
        """(trainable, frozen) of the live modules (after
        ``parallel.shard_model``, their sharded parameters): the fp32
        adapter; the student's frozen trunk (its quantized buffers in place
        of the quantized weights) and the tied teacher's head, or the
        untied teacher whole."""
        student = self.diffusion.denoising.state_dict(keep_vars=True)
        trainable = {n: t for n, t in student.items() if n in self._adapter}
        frozen = {'base': {n: t for n, t in student.items()
                           if n not in self._adapter}}
        if self.teacher is not None:
            teacher = self.teacher.denoising.state_dict(keep_vars=True)
            if self.tie_teacher:
                frozen['teacher_head'] = {
                    n: t for n, t in teacher.items()
                    if name_matches(n, TEACHER_HEAD_KEYS, exact_prefix=True)}
            else:
                frozen['teacher_full'] = teacher
        return {'diffusion': trainable}, frozen

    # ---- batch plumbing ------------------------------------------------------
    def _prompt_embeds(self, batch: dict, negative: bool = False
                       ) -> Dict[str, torch.Tensor]:
        prefix = 'negative_' if negative else ''
        key = f'{prefix}prompt_embed_kwargs'
        if key in batch:
            embeds = dict(batch[key])
        elif f'{prefix}prompt_kwargs' in batch:
            if self.text_encoder is None:
                raise ValueError('text_encoder required to embed raw '
                                 'prompts')
            key = f'{prefix}prompt_kwargs'
            embeds = dict(self.text_encoder(**batch[key]))
        else:
            raise ValueError(f'batch needs {prefix}prompt_embed_kwargs or '
                             f'{prefix}prompt_kwargs')
        self._check_embeds(embeds, key)
        return embeds

    def _guidance(self, scale, n: int, device) -> dict:
        """The distilled-guidance kwarg for ``n`` samples at ``scale``, for
        denoisers with guidance embeds (FLUX); none for Qwen."""
        if scale is None or not self.diffusion.denoising.guidance_embeds:
            return {}
        return dict(guidance=torch.full((n,), scale, dtype=torch.float32,
                                        device=device))

    def _check_embeds(self, embeds: dict, key: str):
        text = embeds['encoder_hidden_states']
        bad = text.shape[-1] != self.text_embed_dim \
            or text.shape[1] > self.max_text_len
        want = f'width {self.text_embed_dim} (at most {self.max_text_len} ' \
               f'tokens)'
        if self.family == 'flux':
            pooled = embeds['pooled_projections']
            bad = bad or pooled.shape[-1] != self.pooled_dim
            want += f', pooled {self.pooled_dim}'
        else:
            mask = embeds.get('encoder_hidden_states_mask')
            bad = bad or (mask is not None
                          and tuple(mask.shape) != tuple(text.shape[:2]))
            want += ', a (B, S) mask'
        if bad:
            raise ValueError(f'{key}: ' + ', '.join(
                f'{k} {tuple(v.shape)}' for k, v in embeds.items())
                + f'; want {want}')

    def _latents(self, batch: dict) -> torch.Tensor:
        if 'latents' in batch:
            latents = batch['latents']
        elif 'images' in batch:
            if self.vae is None:
                raise ValueError('vae required to encode images')
            with torch.no_grad():
                latents = self.vae.encode(batch['images'] * 2 - 1)
        else:
            raise ValueError('batch needs latents or images')
        if latents.ndim != 4 or latents.shape[-1] != self.latent_shape[-1]:
            raise ValueError(f'latents {tuple(latents.shape)}, want '
                             f'(B, h, w, {self.latent_shape[-1]})')
        return latents

    def _teacher_fn(self, batch: dict, bs: int):
        """The frozen teacher's u with CFG and distilled guidance."""
        gs = self.train_cfg.get('teacher_guidance_scale', None)
        use_cfg = gs is not None and gs not in (0.0, 1.0)
        pos = self._prompt_embeds(batch)
        if use_cfg:
            neg = self._prompt_embeds(batch, negative=True)
            kwargs = {k: torch.cat([neg[k], v], dim=0) for k, v in pos.items()}
        else:
            gs = 1.0
            kwargs = pos
        kwargs.update(self._guidance(
            self.train_cfg.get('teacher_distilled_guidance_scale', None),
            2 * bs if use_cfg else bs,
            pos['encoder_hidden_states'].device))

        def fn(x_t, t):
            with lora_disabled(self.teacher.denoising):
                return self.teacher.forward_u(x_t, t, guidance_scale=gs,
                                              **kwargs)
        return fn

    # ---- training ---------------------------------------------------------------
    def loss(self, batch: dict, generator: torch.Generator,
             running_status: Optional[dict] = None):
        latents = self._latents(batch)
        bs = latents.shape[0]
        kwargs = self._prompt_embeds(batch)
        kwargs.update(self._guidance(
            self.train_cfg.get('distilled_guidance_scale', None), bs,
            latents.device))
        teacher_fn = self._teacher_fn(batch, bs) \
            if self.teacher is not None else None
        return multistep_train_loss(
            self.diffusion, generator, latents, teacher_fn=teacher_fn,
            running_status=running_status, **kwargs)

    # ---- evaluation --------------------------------------------------------------
    @torch.no_grad()
    def val_step(self, batch: dict, generator: Optional[torch.Generator],
                 ema: Optional[Dict[str, torch.Tensor]] = None,
                 test_cfg_override: Optional[dict] = None, **kwargs):
        """Samples of the student (JAX ``val_step``): with ``ema`` (the
        state's EMA of the adapter) in place of the live adapter, the
        distilled guidance of the test config, from ``batch['noise']`` or
        normal draws from ``generator``; decoded and clipped to [0, 1] when
        the model has a VAE (``pred_imgs``), else the latents
        (``pred_latents``)."""
        cfg = dict(self.test_cfg, **(test_cfg_override or {}))
        embeds = self._prompt_embeds(batch)
        text = embeds['encoder_hidden_states']
        bs = text.shape[0]
        embeds.update(self._guidance(cfg.get('distilled_guidance_scale', None),
                                     bs, text.device))
        noise = batch.get('noise')
        if noise is None:
            h, w, c = cfg.get('latent_size', self.latent_shape)
            noise = torch.randn((bs, h, w, c), generator=generator,
                                device=text.device)
        with swapped_params(self.diffusion.denoising, ema or {}):
            latents = self.diffusion.forward_test(
                noise, generator, test_cfg_override=test_cfg_override,
                **embeds)
        if self.vae is not None:
            imgs = self.vae.decode(latents)
            return dict(num_samples=bs,
                        pred_imgs=torch.clamp(imgs / 2 + 0.5, 0.0, 1.0))
        return dict(num_samples=bs, pred_latents=latents)
