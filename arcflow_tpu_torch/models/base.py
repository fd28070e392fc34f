"""Model compositions: the base, the 2-D toy diffusion and the 2-D toy
distillation.

Counterpart of ``arcflow_tpu/models/base.py`` (``BaseModel``,
``Diffusion2D``, ``Distillation2D``). The JAX composition owns static module
definitions and takes its parameters in every call; here the submodules
hold their parameters, ``init_params`` hands out the live (trainable,
frozen) split as {submodule: {name: tensor}}, and ``loss`` draws its
randomness from an explicit ``torch.Generator``. Submodules are built from
their configs through ``MODULES``; flax infers the toy denoisers' input
widths at init, here the compositions pass ``data_shape`` to them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..diffusion.arcflow import multistep_train_loss
from ..parallel.fsdp import is_sharded, local
from ..registry import MODELS, MODULES


class BaseModel:
    """Base composition: subclasses build submodules and define the loss."""

    def __init__(self, train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})

    def init_params(self) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                   Dict[str, Dict[str, torch.Tensor]]]:
        """(trainable, frozen) as {submodule: {parameter name: tensor}}: the
        tensors the modules compute with, not copies."""
        raise NotImplementedError

    def loss(self, batch: dict, generator: torch.Generator,
             running_status: Optional[dict] = None):
        """(loss, log_vars) of one batch; the loss is differentiable in the
        trainable parameters."""
        raise NotImplementedError

    @property
    def ema_keys(self) -> Tuple[str, ...]:
        """Trainable submodule keys that keep an EMA copy."""
        return ()

    def fsdp_modules(self) -> Dict[str, nn.Module]:
        """The modules whose parameters the loss trains or reads, which
        ``parallel.shard_model`` shards: the denoisers of the student's
        diffusion and of the teacher, where there is one."""
        return {k: flow.denoising for k in ('diffusion', 'teacher')
                if (flow := getattr(self, k, None)) is not None}


@contextlib.contextmanager
def swapped_params(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """Run ``module`` with ``tensors`` (e.g. the EMA copy) in place of its
    parameters of those names, then put its own back. A sharded parameter
    (FSDP2 gathers from its own storage) takes the tensor's shard by a
    copy into it."""
    params = dict(module.named_parameters())
    sharded = {n for n in tensors if is_sharded(params[n])}
    own = {n: local(params[n]).clone() if n in sharded else params[n].data
           for n in tensors}
    try:
        with torch.no_grad():
            for n, t in tensors.items():
                if n in sharded:
                    local(params[n]).copy_(local(t))
                else:
                    params[n].data = t
        yield module
    finally:
        with torch.no_grad():
            for n, t in own.items():
                if n in sharded:
                    local(params[n]).copy_(t)
                else:
                    params[n].data = t


def _with_data_shape(cfg, data_shape):
    """``cfg`` with ``data_shape`` given to its denoiser's config, where
    the denoiser comes as a config and does not set it."""
    if not isinstance(cfg, dict) or not isinstance(cfg.get('denoising'),
                                                   dict):
        return cfg
    return dict(cfg, denoising=dict(dict(data_shape=tuple(data_shape)),
                                    **cfg['denoising']))


class _Toy2D(BaseModel):
    """What the 2-D toys share: a student diffusion built from its config
    on ``device`` (the card unless the caller says otherwise), trainable in
    fp32, the batch's ``x`` reshaped to (B, *data_shape), and sampling."""

    def __init__(self, diffusion: dict, data_shape, diffusion_use_ema: bool,
                 train_cfg: Optional[dict], test_cfg: Optional[dict],
                 device):
        super().__init__(train_cfg, test_cfg)
        self.data_shape = tuple(data_shape)
        self.diffusion_use_ema = diffusion_use_ema
        self.device = torch.device(device)
        self.diffusion = MODULES.build(
            _with_data_shape(diffusion, self.data_shape),
            default_args=dict(train_cfg=self.train_cfg,
                              test_cfg=self.test_cfg, device=device))

    @property
    def ema_keys(self):
        return ('diffusion',) if self.diffusion_use_ema else ()

    def _x_0(self, batch: dict) -> torch.Tensor:
        return batch['x'].reshape(-1, *self.data_shape)

    @torch.no_grad()
    def val_step(self, batch: dict, generator: Optional[torch.Generator],
                 ema: Optional[Dict[str, torch.Tensor]] = None, **kwargs):
        """Samples from ``batch['noise']`` or, without it, from
        ``batch['num_samples']`` standard normal draws; with ``ema`` (the
        state's EMA of ``init_params``' tensors) the EMA weights are used."""
        noise = batch.get('noise')
        if noise is None:
            noise = torch.randn((batch['num_samples'], *self.data_shape),
                                generator=generator, device=self.device)
        with swapped_params(self.diffusion.denoising, ema or {}):
            return self.diffusion.forward_test(noise, generator, **kwargs)


@MODELS.register_module()
class Diffusion2D(_Toy2D):
    """2-D toy diffusion on (B, *data_shape) points: any registered
    diffusion (``GaussianFlow`` around a ``ToyMLPDenoiser``, ``GMFlow``
    around a ``ToyGMFlowDenoiser``, ...); its denoiser's parameters are the
    trainable ones."""

    def __init__(self, diffusion: dict, data_shape=(2,),
                 diffusion_use_ema: bool = True,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, device='cuda'):
        super().__init__(diffusion, data_shape, diffusion_use_ema, train_cfg,
                         test_cfg, device)

    def init_params(self):
        return {'diffusion': dict(
            self.diffusion.denoising.named_parameters())}, {}

    def loss(self, batch: dict, generator: torch.Generator,
             running_status: Optional[dict] = None):
        return self.diffusion.forward_train(generator, self._x_0(batch),
                                            running_status=running_status)


@MODELS.register_module()
class Distillation2D(_Toy2D):
    """2-D toy distillation: a frozen flow teacher (a ``GaussianFlow``
    whose weights are ``frozen['teacher']``) and a few-step ArcFlow student
    that gets the teacher as a ``teacher_fn`` closure.

    ``teacher_ckpt`` is a checkpoint directory of the port's own format
    (``runner/checkpoint.py``), read with ``load_raw_checkpoint``: the
    teacher takes its EMA when it has one and ``teacher_use_ema``, else its
    trainable weights. ``teacher_quant`` ('int8' or 'int4') then quantizes
    the teacher's ``LoRADense`` kernels of at least
    ``teacher_quant_min_size`` elements with ``utils/quantize.py``
    (int4 in groups of ``teacher_quant_group_size``)."""

    def __init__(self, diffusion: dict, teacher: dict, data_shape=(2,),
                 diffusion_use_ema: bool = True,
                 teacher_guidance_scale: float = 1.0, teacher_ckpt=None,
                 teacher_use_ema: bool = True, teacher_quant=None,
                 teacher_quant_min_size: int = 1024,
                 teacher_quant_group_size: int = 32,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, device='cuda'):
        if teacher_quant not in (None, 'int8', 'int4'):
            raise ValueError(f'teacher_quant {teacher_quant!r}: want None, '
                             f'int8 or int4')
        super().__init__(diffusion, data_shape, diffusion_use_ema, train_cfg,
                         test_cfg, device)
        self.teacher = MODULES.build(
            _with_data_shape(teacher, self.data_shape),
            default_args=dict(device=device))
        self.teacher_guidance_scale = teacher_guidance_scale
        t_model = self.teacher.denoising.requires_grad_(False)
        if teacher_ckpt:
            from ..runner.checkpoint import load_raw_checkpoint
            raw = load_raw_checkpoint(teacher_ckpt)
            src = raw['ema'] if teacher_use_ema and raw.get('ema') \
                else raw['trainable']
            t_model.load_state_dict(src['diffusion'], strict=True)
        if teacher_quant is not None:
            from ..utils import quantize
            if teacher_quant == 'int8':
                quantize.quantize_weights_int8(
                    t_model, min_size=teacher_quant_min_size)
            else:
                quantize.quantize_weights_int4(
                    t_model, min_size=teacher_quant_min_size,
                    group_size=teacher_quant_group_size)

    def init_params(self):
        # the teacher's every parameter and buffer (a quantized kernel is
        # one), live
        return ({'diffusion': dict(
            self.diffusion.denoising.named_parameters())},
            {'teacher': dict(self.teacher.denoising.state_dict(
                keep_vars=True))})

    def teacher_fn(self, x_t: torch.Tensor, t: torch.Tensor, **kwargs):
        """The frozen teacher's u at (x_t, t), with its guidance scale."""
        with torch.no_grad():
            return self.teacher.forward_u(
                x_t, t, guidance_scale=self.teacher_guidance_scale, **kwargs)

    def loss(self, batch: dict, generator: torch.Generator,
             running_status: Optional[dict] = None):
        return multistep_train_loss(
            self.diffusion, generator, self._x_0(batch),
            teacher_fn=self.teacher_fn, running_status=running_status)
