"""Latent text-to-image distillation composition: the student, its frozen
trunk shared with the teacher, and the distillation loss.

Counterpart of ``arcflow_tpu/models/latent_diffusion.py:LatentDiffusionTextImage``
and its weight economy:

* the student's adapter (``ARCFLUX_ADAPTER_KEYS``: the three heads,
  ``norm_out`` and every LoRA leaf) is trainable and stored in fp32;
* the rest of the student is the frozen trunk, stored in ``frozen_dtype``
  (fp32 when None, as the JAX ``param_dtype``);
* the tied teacher has no LoRA and its own frozen head
  (``TEACHER_HEAD_KEYS``); every other teacher parameter IS the student's
  frozen tensor, so the trunk is in memory once (the JAX dict overlay,
  ``latent_diffusion.py:256-273``).

Configs are the JAX package's dicts (``type`` keys included); the port
builds the few types this path uses itself, as it has no registry yet.
Modules are made on ``device`` (the card unless the caller says otherwise)
and compute in ``dtype``. Prompt embeds and latents come in the batch and
are checked against ``latent_shape``, ``text_embed_dim``, ``pooled_dim``
and ``max_text_len``: ``pretrained`` loading, ``frozen_quant``, the text
encoder, the VAE encode and ``val_step`` wait for their slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..diffusion.arcflow import ArcFlowImitationDataFree, multistep_train_loss
from ..diffusion.gaussian_flow import GaussianFlow
from ..diffusion.losses import DiffusionMSELoss
from ..diffusion.sampler import ContinuousTimeStepSampler
from ..utils.pytree import name_matches
from .base import BaseModel, _typed
from .flux import (ARCFLUX_ADAPTER_KEYS, ArcFluxTransformer2DModel,
                   FluxTransformer2DModel)

# the teacher's own head; the rest of it is the student's frozen trunk
TEACHER_HEAD_KEYS = ('proj_out', 'norm_out')
_DENOISERS = {'ArcFluxTransformer2DModel': ArcFluxTransformer2DModel,
              'FluxTransformer2DModel': FluxTransformer2DModel}
# fields of the JAX configs that the port's FLUX models fix
_FIXED = dict(patch_size=2, guidance_embeds=True, pretrained=None,
              pretrained_adapter=None)


def _build_denoiser(cfg: dict, device, dtype) -> nn.Module:
    cfg = dict(cfg)
    cls = _DENOISERS[cfg.pop('type')]
    for key, value in _FIXED.items():
        if key in cfg and cfg.pop(key) != value:
            raise ValueError(f'{key} must be {value} in the port')
    return cls(device=device, dtype=dtype, **cfg)


def _flow_kwargs(cfg: dict) -> dict:
    """GaussianFlow arguments from a JAX diffusion/teacher config."""
    cfg = dict(cfg)
    if cfg.pop('denoising_mean_mode', 'U').upper() != 'U':
        raise ValueError('only u-prediction is ported')
    out = dict(num_timesteps=cfg.pop('num_timesteps', 1000))
    if cfg.get('flow_loss') is not None:
        out['flow_loss'] = DiffusionMSELoss(
            **_typed(cfg.pop('flow_loss'), 'DiffusionMSELoss'))
    if cfg.get('timestep_sampler') is not None:
        out['timestep_sampler'] = ContinuousTimeStepSampler(
            **_typed(cfg.pop('timestep_sampler'), 'ContinuousTimeStepSampler'))
    return out


def _set_param(root: nn.Module, name: str, param: nn.Parameter):
    *path, leaf = name.split('.')
    module = root.get_submodule('.'.join(path)) if path else root
    module._parameters[leaf] = param


class LatentDiffusionTextImage(BaseModel):

    def __init__(self, diffusion: dict, teacher: Optional[dict] = None,
                 diffusion_use_ema: bool = True, tie_teacher: bool = True,
                 latent_shape: Tuple[int, int, int] = (64, 64, 16),
                 text_embed_dim: int = 4096, pooled_dim: int = 768,
                 max_text_len: int = 512,
                 frozen_dtype: Union[None, str, torch.dtype] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, device='cuda',
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(train_cfg, test_cfg)
        if not tie_teacher:
            raise ValueError('the port ties the teacher to the student trunk')
        if isinstance(frozen_dtype, str):
            frozen_dtype = getattr(torch, frozen_dtype)
        self.frozen_dtype = frozen_dtype or torch.float32
        self.diffusion_use_ema = diffusion_use_ema
        self.latent_shape = tuple(latent_shape)
        self.text_embed_dim = text_embed_dim
        self.pooled_dim = pooled_dim
        self.max_text_len = max_text_len

        cfg = _typed(diffusion, 'ArcFlowImitationDataFree')
        if cfg.pop('policy_type', 'ArcFlow') != 'ArcFlow':
            raise ValueError('the port builds the ArcFlow policy only')
        student = _build_denoiser(cfg.pop('denoising'), device, dtype)
        self.diffusion = ArcFlowImitationDataFree(
            denoising=student, train_cfg=self.train_cfg,
            test_cfg=self.test_cfg, **_flow_kwargs(cfg))
        self._adapter, self._base = {}, {}
        for name, p in student.named_parameters():
            if name_matches(name, ARCFLUX_ADAPTER_KEYS):
                p.data = p.data.float()
                self._adapter[name] = p.requires_grad_(True)
            else:
                p.data = p.data.to(self.frozen_dtype)
                self._base[name] = p.requires_grad_(False)

        self.teacher = None
        self._teacher_head = {}
        if teacher:
            cfg = _typed(teacher, 'GaussianFlow')
            # the trunk without storage: it borrows the student's below
            t_model = _build_denoiser(cfg.pop('denoising'), 'meta', dtype)
            t_model.init_head(device=device, dtype=dtype)
            for name, p in t_model.named_parameters():
                if name_matches(name, TEACHER_HEAD_KEYS, exact_prefix=True):
                    p.data = p.data.to(self.frozen_dtype)
                    self._teacher_head[name] = p.requires_grad_(False)
                    continue
                shared = self._base.get(name)
                if shared is None or shared.shape != p.shape:
                    raise ValueError(f'teacher parameter {name} has no '
                                     f'frozen student twin')
                _set_param(t_model, name, shared)
            self.teacher = GaussianFlow(denoising=t_model,
                                        **_flow_kwargs(cfg))

    @property
    def ema_keys(self):
        return ('diffusion',) if self.diffusion_use_ema else ()

    def init_params(self):
        frozen = {'base': dict(self._base)}
        if self.teacher is not None:
            frozen['teacher_head'] = dict(self._teacher_head)
        return {'diffusion': dict(self._adapter)}, frozen

    # ---- batch plumbing ------------------------------------------------------
    def _prompt_embeds(self, batch: dict, negative: bool = False
                       ) -> Dict[str, torch.Tensor]:
        key = ('negative_' if negative else '') + 'prompt_embed_kwargs'
        if key not in batch:
            raise ValueError(f'batch needs {key} (the text encoder is not '
                             f'ported yet)')
        embeds = dict(batch[key])
        text = embeds['encoder_hidden_states']
        if (text.shape[-1] != self.text_embed_dim
                or text.shape[1] > self.max_text_len
                or embeds['pooled_projections'].shape[-1] != self.pooled_dim):
            raise ValueError(f'{key}: text {tuple(text.shape)}, pooled '
                             f'{tuple(embeds["pooled_projections"].shape)}; '
                             f'want width {self.text_embed_dim} (at most '
                             f'{self.max_text_len} tokens), {self.pooled_dim}')
        return embeds

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
        tdg = self.train_cfg.get('teacher_distilled_guidance_scale', None)
        if tdg is not None:
            dev = next(iter(pos.values())).device
            kwargs['guidance'] = torch.full((2 * bs if use_cfg else bs,), tdg,
                                            dtype=torch.float32, device=dev)

        def fn(x_t, t):
            return self.teacher.forward_u(x_t, t, guidance_scale=gs, **kwargs)
        return fn

    # ---- training ---------------------------------------------------------------
    def loss(self, batch: dict, generator: torch.Generator,
             running_status: Optional[dict] = None):
        if 'latents' not in batch:
            raise ValueError('batch needs latents (the VAE encode is not '
                             'ported yet)')
        latents = batch['latents']
        if tuple(latents.shape[1:]) != self.latent_shape:
            raise ValueError(f'latents {tuple(latents.shape)}, want '
                             f'(B, *{self.latent_shape})')
        bs = latents.shape[0]
        kwargs = self._prompt_embeds(batch)
        dgs = self.train_cfg.get('distilled_guidance_scale', None)
        if dgs is not None:
            kwargs['guidance'] = torch.full((bs,), dgs, dtype=torch.float32,
                                            device=latents.device)
        teacher_fn = self._teacher_fn(batch, bs) \
            if self.teacher is not None else None
        return multistep_train_loss(
            self.diffusion, generator, latents, teacher_fn=teacher_fn,
            running_status=running_status, **kwargs)
