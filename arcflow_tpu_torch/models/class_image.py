"""Class-conditional latent diffusion composition (the ImageNet path).

Counterpart of ``arcflow_tpu/models/class_image.py:LatentDiffusionClassImage``:
label conditioning with ``prob_class`` dropout to the null class (CFG
training), the null-label concat for guided teachers and guided sampling,
cached latents as input, and an optional frozen teacher for distillation,
read from a flow run's checkpoint and grafted into the student.

The whole student denoiser is trainable (``trainable['diffusion']``); the
teacher's every tensor is frozen (``frozen['teacher']``). Submodules come
from their configs through ``MODULES`` on ``device`` (the card unless the
caller says otherwise), the UNets with ``latent_shape`` as their
``data_shape``. Draws come from the step's ``torch.Generator`` in JAX's
order: the label dropout, then the loss's. The graft's bias noise and the
heads' init come from torch's global generator.

``vae`` is built but never decodes: JAX's ``val_step`` decodes only when
the state's frozen tree holds ``'vae'``, which ``init_params`` never puts
there (``arcflow_tpu/models/class_image.py:57-78,159-162``), so JAX returns
latents with or without a VAE, and so does the port.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..diffusion.arcflow import ArcFlowImitationBase, multistep_train_loss
from ..parallel.mesh import batch_draw
from ..registry import MODELS, MODULES
from .base import BaseModel, _with_data_shape, swapped_params

GRAFT_NOISE = 0.05


@MODELS.register_module()
class LatentDiffusionClassImage(BaseModel):

    def __init__(self, diffusion: dict, teacher: Optional[dict] = None,
                 vae: Optional[dict] = None, num_classes: int = 1000,
                 prob_class: float = 0.1, diffusion_use_ema: bool = True,
                 latent_shape: Tuple[int, int, int] = (32, 32, 4),
                 teacher_ckpt: Optional[str] = None,
                 teacher_use_ema: bool = True,
                 student_init_from_teacher: bool = False,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, device='cuda'):
        super().__init__(train_cfg, test_cfg)
        self.device = torch.device(device)
        self.num_classes = num_classes
        self.prob_class = prob_class
        self.diffusion_use_ema = diffusion_use_ema
        self.latent_shape = tuple(latent_shape)
        self.diffusion = MODULES.build(
            _with_data_shape(diffusion, self.latent_shape),
            default_args=dict(train_cfg=self.train_cfg,
                              test_cfg=self.test_cfg, device=device))
        self.teacher = MODULES.build(
            _with_data_shape(teacher, self.latent_shape),
            default_args=dict(device=device)) if teacher else None
        self.vae = MODULES.build(vae, default_args=dict(device=device)) \
            if vae else None
        if self.teacher is None:
            return
        t_model = self.teacher.denoising.requires_grad_(False)
        if teacher_ckpt:
            from ..runner.checkpoint import load_raw_checkpoint
            raw = load_raw_checkpoint(teacher_ckpt)
            src = raw['ema'] if teacher_use_ema and raw.get('ema') \
                else raw['trainable']
            t_model.load_state_dict(src['diffusion'], strict=True)
        if student_init_from_teacher:
            self._graft_student_from_teacher()

    @property
    def ema_keys(self):
        return ('diffusion',) if self.diffusion_use_ema else ()

    def init_params(self):
        """({'diffusion': the student's parameters}, {'teacher': the
        teacher's tensors} or {}), live."""
        frozen = {} if self.teacher is None else {
            'teacher': dict(self.teacher.denoising.state_dict(
                keep_vars=True))}
        return {'diffusion': dict(
            self.diffusion.denoising.named_parameters())}, frozen

    @torch.no_grad()
    def _graft_student_from_teacher(self):
        """The student's every tensor of the teacher's name and shape
        copied from the teacher (the trunk), and the teacher's ``conv_out``
        tiled over the K-way means head (output channel k * C + c takes the
        teacher's channel c) with 0.05 N(0, 1) noise on its bias: the UNet
        analogue of the reference's proj_out expansion."""
        student = dict(self.diffusion.denoising.named_parameters())
        teacher = dict(self.teacher.denoising.named_parameters())
        for name, t in teacher.items():
            s = student.get(name)
            if s is not None and s.shape == t.shape:
                s.copy_(t)
        if 'proj_out_means.weight' in student and \
                'conv_out.weight' in teacher:
            kern, bias = teacher['conv_out.weight'], teacher['conv_out.bias']
            means_w, means_b = (student['proj_out_means.weight'],
                                student['proj_out_means.bias'])
            k = means_w.shape[0] // kern.shape[0]
            means_w.copy_(kern.repeat(k, 1, 1, 1))
            noise = torch.randn(means_b.shape, dtype=torch.float32,
                                device=means_b.device)
            means_b.copy_(bias.float().repeat(k) + GRAFT_NOISE * noise)

    def _labels_with_dropout(self, generator: torch.Generator,
                             labels: torch.Tensor) -> torch.Tensor:
        """Labels replaced by the null class with probability
        ``prob_class`` (one uniform draw per sample)."""
        if self.prob_class <= 0:
            return labels
        drop = batch_draw(torch.rand, labels.shape, generator=generator,
                          device=labels.device) < self.prob_class
        return torch.where(drop, torch.full_like(labels, self.num_classes),
                           labels)

    def _with_null(self, labels: torch.Tensor, scale) -> torch.Tensor:
        """``cat([null, labels])`` for a guidance scale other than 0 and 1
        (the CFG batch's negative half first), else ``labels``."""
        if scale in (0.0, 1.0):
            return labels
        return torch.cat([torch.full_like(labels, self.num_classes), labels])

    def teacher_fn(self, x_t: torch.Tensor, t: torch.Tensor,
                   label: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The frozen teacher's u at (x_t, t), with CFG at
        ``teacher_guidance_scale`` on the labels and the null class."""
        gs = self.train_cfg.get('teacher_guidance_scale', 1.0) or 1.0
        with torch.no_grad():
            if label is not None and gs not in (0.0, 1.0):
                return self.teacher.forward_u(
                    x_t, t, guidance_scale=gs,
                    label=self._with_null(label, gs))
            return self.teacher.forward_u(x_t, t, label=label)

    def loss(self, batch: dict, generator: torch.Generator,
             running_status: Optional[dict] = None):
        latents = batch['latents']
        labels = self._labels_with_dropout(generator, batch['label'].long())
        if self.teacher is not None:
            return multistep_train_loss(
                self.diffusion, generator, latents,
                teacher_fn=lambda x_t, t: self.teacher_fn(x_t, t, labels),
                running_status=running_status, label=labels)
        return self.diffusion.forward_train(
            generator, latents, running_status=running_status, label=labels)

    @torch.no_grad()
    def val_step(self, batch: dict, generator: Optional[torch.Generator],
                 ema: Optional[Dict[str, torch.Tensor]] = None,
                 guidance_scale: float = 1.0,
                 test_cfg_override: Optional[dict] = None, **kwargs):
        """Samples of the student for ``batch['label']``: with ``ema`` (the
        state's EMA of the student) in place of the live weights, CFG at
        ``guidance_scale`` against the null class, from ``batch['noise']``
        or normal draws from ``generator``. Returns the latents
        (``pred_latents``); see the module docstring for the VAE. An
        ArcFlow student takes no CFG: JAX concatenates the null labels and
        then fails on their doubled batch
        (``arcflow_tpu/models/class_image.py:154-158``); the port refuses
        it by name."""
        if guidance_scale not in (0.0, 1.0) and \
                isinstance(self.diffusion, ArcFlowImitationBase):
            raise ValueError(
                f'guidance_scale {guidance_scale}: an ArcFlow student '
                f'samples without CFG (its teacher\'s guidance is distilled '
                f'into it); JAX fails here on the doubled labels')
        labels = torch.as_tensor(batch['label'],
                                 device=self.device).long()
        noise = batch.get('noise')
        if noise is None:
            noise = torch.randn((labels.shape[0], *self.latent_shape),
                                generator=generator, device=self.device)
        noise = torch.as_tensor(noise, device=self.device)
        with swapped_params(self.diffusion.denoising, ema or {}):
            latents = self.diffusion.forward_test(
                noise, generator, guidance_scale=guidance_scale,
                test_cfg_override=test_cfg_override,
                label=self._with_null(labels, guidance_scale))
        return dict(num_samples=labels.shape[0], pred_latents=latents)
