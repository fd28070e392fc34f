"""Model composition base and the 2-D toy diffusion.

Counterpart of ``arcflow_tpu/models/base.py`` (``BaseModel``,
``Diffusion2D``). The JAX composition owns static module definitions and
takes its parameters in every call; here the submodules hold their
parameters, ``init_params`` hands out the live (trainable, frozen) split as
{submodule: {name: tensor}}, and ``loss`` draws its randomness from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..diffusion.gmflow import GMFlow
from ..diffusion.losses import GMFlowNLLLoss
from ..diffusion.sampler import ContinuousTimeStepSampler
from .toy import ToyGMFlowDenoiser


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


def _typed(cfg: dict, want: str) -> dict:
    cfg = dict(cfg)
    got = cfg.pop('type', want)
    if got != want:
        raise ValueError(f'the port builds {want} here, got {got}')
    return cfg


@contextlib.contextmanager
def swapped_params(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """Run ``module`` with ``tensors`` (e.g. the EMA copy) in place of its
    parameters of those names, then put its own back."""
    params = dict(module.named_parameters())
    own = {n: params[n].data for n in tensors}
    try:
        for n, t in tensors.items():
            params[n].data = t
        yield module
    finally:
        for n, t in own.items():
            params[n].data = t


class Diffusion2D(BaseModel):
    """2-D toy diffusion on (B, *data_shape) points; the diffusion config is
    the JAX package's dict (``configs/gmflow/checkerboard_gmflow.py``): a
    ``GMFlow`` around a ``ToyGMFlowDenoiser`` with a ``GMFlowNLLLoss``. Its
    parameters are trainable fp32 and made on ``device`` (the card unless
    the caller says otherwise). No config of the repo gives it a spectrum
    net; ``GMFlow`` itself takes one."""

    def __init__(self, diffusion: dict, data_shape=(2,),
                 diffusion_use_ema: bool = True,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, device='cuda'):
        super().__init__(train_cfg, test_cfg)
        self.data_shape = tuple(data_shape)
        self.diffusion_use_ema = diffusion_use_ema
        if len(self.data_shape) != 3:
            raise ValueError('GMFlow takes (H, W, C) points, got data_shape '
                             f'{self.data_shape}')
        cfg = _typed(diffusion, 'GMFlow')
        num_timesteps = cfg.pop('num_timesteps', 1000)
        denoising = ToyGMFlowDenoiser(
            hw=self.data_shape[:2], device=device,
            **_typed(cfg.pop('denoising'), 'ToyGMFlowDenoiser'))
        sampler = ContinuousTimeStepSampler(**dict(
            dict(num_timesteps=num_timesteps),
            **_typed(cfg.pop('timestep_sampler', None) or {},
                     'ContinuousTimeStepSampler')))
        loss = cfg.pop('flow_loss', None)
        self.diffusion = GMFlow(
            denoising=denoising, num_timesteps=num_timesteps,
            flow_loss=None if loss is None
            else GMFlowNLLLoss(**_typed(loss, 'GMFlowNLLLoss')),
            timestep_sampler=sampler, train_cfg=self.train_cfg,
            test_cfg=self.test_cfg, **cfg)

    @property
    def ema_keys(self):
        return ('diffusion',) if self.diffusion_use_ema else ()

    def init_params(self):
        return {'diffusion': dict(
            self.diffusion.denoising.named_parameters())}, {}

    def loss(self, batch: dict, generator: torch.Generator,
             running_status: Optional[dict] = None):
        x_0 = batch['x'].reshape(-1, *self.data_shape)
        return self.diffusion.forward_train(generator, x_0,
                                            running_status=running_status)

    @torch.no_grad()
    def val_step(self, batch: dict, generator: Optional[torch.Generator],
                 ema: Optional[Dict[str, torch.Tensor]] = None, **kwargs):
        """Samples from ``batch['noise']`` or, without it, from
        ``batch['num_samples']`` standard normal draws; with ``ema`` (the
        state's EMA of ``init_params``' tensors) the EMA weights are used."""
        denoising = self.diffusion.denoising
        noise = batch.get('noise')
        if noise is None:
            noise = torch.randn((batch['num_samples'], *self.data_shape),
                                generator=generator,
                                device=denoising.logstd.device)
        with swapped_params(denoising, ema or {}):
            return self.diffusion.forward_test(noise, generator, **kwargs)
