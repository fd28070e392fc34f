"""Rectified-flow (flow-matching) base module.

Counterpart of ``arcflow_tpu/diffusion/gaussian_flow.py``: the forward
process ``x_t = (1 - sigma) x_0 + sigma eps``, the u-prediction training
loss (``loss``, ``forward_train``), CFG with its orthogonal and interval
forms (``forward_u``) and the scheduler-driven sampler (``forward_test``).
The JAX module passes params and PRNG keys into every method; here the
denoiser is an ``nn.Module`` holding its parameters, randomness comes from
an explicit ``torch.Generator``, and the sampler is a Python loop over the
host-computed sigma grid where the JAX module runs one ``lax.scan``.
Submodules come as built objects or as registry configs, as in JAX.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch

from ..parallel.mesh import batch_draw
from ..registry import MODULES, SCHEDULERS


def apply_guidance(pos: torch.Tensor, neg: torch.Tensor,
                   guidance_scale: float,
                   orthogonal: bool = False) -> torch.Tensor:
    """Classifier-free guidance bias (pos - neg) * (scale - 1); with
    ``orthogonal`` its component along ``pos`` is removed."""
    bias = (pos - neg) * (guidance_scale - 1.0)
    if orthogonal:
        dims = tuple(range(1, pos.dim()))
        num = (bias * pos).mean(dim=dims, keepdim=True)
        den = (pos * pos).mean(dim=dims, keepdim=True).clamp_min(1e-6)
        bias = bias - num / den * pos
    return bias


def _bview(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) with ``ndim`` dims."""
    return a.reshape(a.shape[0], *((ndim - a.dim()) * [1])) \
        if a.dim() < ndim else a


def denoiser_args(device=None, dtype=None) -> dict:
    """``default_args`` for building a denoiser: its device, and its dtype
    when one is given (the toy denoisers are fp32 by default)."""
    return dict(device=device, **({} if dtype is None else dict(dtype=dtype)))


@MODULES.register_module()
class GaussianFlow:
    """Flow-matching wrapper around a denoiser ``nn.Module`` whose forward is
    ``denoising(x_t, t, **cond)``. ``denoising`` is a module or a
    ``MODULES`` config, built on ``device`` in ``dtype``. Only the U mean
    mode (u-prediction) is ported."""

    is_multistep = False

    def __init__(self, denoising=None, flow_loss=None,
                 num_timesteps: int = 1000, timestep_sampler=None,
                 flip_model_timesteps: bool = False,
                 denoising_mean_mode: str = 'U',
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, device=None, dtype=None):
        if denoising_mean_mode.upper() != 'U':
            raise ValueError(f'denoising_mean_mode {denoising_mean_mode!r}: '
                             f'only u-prediction (U) is ported')
        self.num_timesteps = num_timesteps
        self.denoising = MODULES.build(denoising,
                                       default_args=denoiser_args(device,
                                                                  dtype))
        self.flip_model_timesteps = flip_model_timesteps
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        if timestep_sampler is None:
            timestep_sampler = dict(type='ContinuousTimeStepSampler',
                                    shift=1.0)
        self.timestep_sampler = MODULES.build(
            timestep_sampler, default_args=dict(num_timesteps=num_timesteps))
        self.flow_loss = MODULES.build(flow_loss)

    # ---- forward process -------------------------------------------------
    def sample_forward_diffusion(self, x_0: torch.Tensor, t: torch.Tensor,
                                 noise: torch.Tensor):
        """x_t = (1 - sigma) x_0 + sigma noise with sigma = t /
        num_timesteps; returns (x_t, 1 - sigma, sigma)."""
        std = _bview(torch.as_tensor(t, dtype=torch.float32)
                     / self.num_timesteps, x_0.dim())
        mean = 1.0 - std
        return x_0 * mean + noise * std, mean, std

    def forward_transition(self, x_t_src: torch.Tensor, sigma_src,
                           sigma_tgt, eps: float = 1e-6):
        """Marginal-preserving transition kernel src -> tgt: ({mean, var},
        scale)."""
        ndim = x_t_src.dim()
        sigma_src = _bview(torch.as_tensor(sigma_src, dtype=torch.float32),
                           ndim)
        sigma_tgt = _bview(torch.as_tensor(sigma_tgt, dtype=torch.float32),
                           ndim)
        scale = (1 - sigma_tgt) / (1 - sigma_src).clamp_min(eps)
        var = sigma_tgt.square() - (scale * sigma_src).square()
        return dict(mean=x_t_src * scale, var=var), scale

    def sample_forward_transition(self, generator: torch.Generator,
                                  x_t_src: torch.Tensor, sigma_src,
                                  sigma_tgt) -> torch.Tensor:
        trans, _ = self.forward_transition(x_t_src, sigma_src, sigma_tgt)
        noise = batch_draw(torch.randn, x_t_src.shape, generator=generator,
                           device=x_t_src.device, dtype=torch.float32)
        return trans['mean'] + noise * torch.sqrt(trans['var'].clamp_min(0.0))

    def pred(self, x_t: torch.Tensor, t, dropout_seed: Optional[int] = None,
             **kwargs):
        """One denoiser forward; ``t`` is model time in [0, num_timesteps],
        a scalar or (B,). ``dropout_seed`` (training only) turns on the
        denoiser's LoRA dropout; without it every forward is deterministic."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x_t.device)
        if t.dim() == 0:
            t = t.expand(x_t.shape[0])
        if self.flip_model_timesteps:
            t = self.num_timesteps - t
        if dropout_seed is not None:
            kwargs['dropout_seed'] = dropout_seed
        return self.denoising(x_t, t, **kwargs)

    def _maybe_dropout_seed(self, generator: torch.Generator
                            ) -> Optional[int]:
        """A dropout seed drawn from ``generator``, only when the denoiser
        has ``lora_dropout`` (so dropout-free models draw nothing)."""
        if getattr(self.denoising, 'lora_dropout', 0.0) > 0.0:
            return int(torch.randint(2 ** 62, (1,), generator=generator,
                                     device=generator.device).item())
        return None

    # ---- training ------------------------------------------------------------
    def loss(self, denoising_output, x_0: torch.Tensor, noise: torch.Tensor,
             t: torch.Tensor, pred_mask: Optional[torch.Tensor] = None):
        """The flow loss of a u prediction (a tensor, or a dict of the
        loss's inputs) against u_t = noise - x_0."""
        loss_kwargs = dict(denoising_output) \
            if isinstance(denoising_output, dict) \
            else dict(u_t_pred=denoising_output)
        loss_kwargs.update(
            u_t=noise - x_0, x_0=x_0, noise=noise, timesteps=t,
            weight=None if pred_mask is None else pred_mask.float())
        return self.flow_loss(loss_kwargs)

    def forward_train(self, generator: torch.Generator, x_0: torch.Tensor,
                      running_status=None, **kwargs):
        """Data-based flow matching on one batch: draws (the LoRA dropout
        seed, only with ``lora_dropout``), t, then the noise, in the JAX
        module's order. Returns (loss, log_vars)."""
        b = x_0.shape[0]
        seq_len = math.prod(x_0.shape[1:-1]) if x_0.dim() > 2 else None
        dropout_seed = self._maybe_dropout_seed(generator)
        t = self.timestep_sampler(generator, b, seq_len=seq_len,
                                  device=x_0.device)
        noise = batch_draw(torch.randn, x_0.shape, generator=generator,
                           device=x_0.device, dtype=torch.float32)
        x_t = self.sample_forward_diffusion(x_0, t, noise)[0]
        out = self.pred(x_t, t, dropout_seed=dropout_seed, **kwargs)
        loss, log_info = self.loss(out, x_0, noise, t)
        return loss, dict(loss_diffusion=loss.detach(), **log_info)

    # ---- velocity query with CFG -------------------------------------------------
    def _guided(self, x_t: torch.Tensor, t: torch.Tensor,
                guidance_scale: float, orthogonal: bool, interval,
                **kwargs) -> torch.Tensor:
        """The denoiser's u at (x_t, t) and, for ``guidance_scale`` > 1,
        the CFG'd u from one call on the 2B batch [x_t, x_t] whose
        conditioning in ``kwargs`` is ``cat([negative, positive])``; the
        bias applies only where t lies in ``interval``."""
        if guidance_scale <= 1.0:
            return self.pred(x_t, t, **kwargs)
        out = self.pred(torch.cat([x_t, x_t], dim=0), torch.cat([t, t], dim=0),
                        **kwargs).float()
        neg, pos = out.chunk(2, dim=0)
        bias = apply_guidance(pos, neg, guidance_scale, orthogonal)
        if interval[0] > 0 or interval[1] < self.num_timesteps:
            active = (t >= interval[0]) & (t <= interval[1])
            bias = torch.where(_bview(active, bias.dim()), bias, 0.0)
        return pos + bias

    def forward_u(self, x_t: torch.Tensor, t: torch.Tensor,
                  guidance_scale: float = 1.0,
                  test_cfg_override: Optional[dict] = None, **kwargs):
        """u at (x_t, t), with CFG when ``guidance_scale`` > 1 (see
        ``_guided``); ``orthogonal_guidance`` and ``guidance_interval`` come
        from ``test_cfg`` and its override."""
        cfg = dict(self.test_cfg, **(test_cfg_override or {}))
        return self._guided(
            x_t, t, guidance_scale, cfg.get('orthogonal_guidance', False),
            cfg.get('guidance_interval', [0, self.num_timesteps]), **kwargs)

    # ---- sampling ------------------------------------------------------------
    def build_test_scheduler(self, cfg: dict):
        """The scheduler ``cfg['sampler']`` names (default 'FlowEulerODE'),
        with ``sampler_kwargs`` and the shift settings of ``cfg`` or, where
        it has none, of the timestep sampler."""
        name = cfg.get('sampler', 'FlowEulerODE')
        sched_cls = SCHEDULERS.get(name + 'Scheduler')
        if sched_cls is None:
            raise AttributeError(f'Cannot find sampler [{name}]. '
                                 f'Available: {sorted(SCHEDULERS.keys())}')
        kwargs = dict(cfg.get('sampler_kwargs', {}))
        for key in ('shift', 'use_dynamic_shifting', 'base_seq_len',
                    'max_seq_len', 'base_logshift', 'max_logshift'):
            if key not in kwargs:
                kwargs[key] = cfg.get(key, getattr(self.timestep_sampler, key))
        return sched_cls(num_train_timesteps=self.num_timesteps, **kwargs)

    @torch.no_grad()
    def forward_test(self, noise: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     guidance_scale: float = 1.0,
                     test_cfg_override: Optional[dict] = None,
                     **kwargs) -> torch.Tensor:
        """Scheduler-driven sampling from ``noise`` over ``num_timesteps``
        steps of the ``sampler``'s sigma grid, with CFG as ``forward_u``;
        a stochastic scheduler draws from ``generator``."""
        cfg = copy.deepcopy(self.test_cfg)
        cfg.update(test_cfg_override or {})
        scheduler = self.build_test_scheduler(cfg)
        num_steps = cfg.get('num_timesteps', self.num_timesteps)
        interval = cfg.get('guidance_interval', [0, self.num_timesteps])
        orthogonal = cfg.get('orthogonal_guidance', False)
        prediction_type = cfg.get('prediction_type', 'u')
        seq_len = math.prod(noise.shape[1:-1]) if noise.dim() > 2 else None
        sigmas = scheduler.set_timesteps(num_steps, seq_len=seq_len)
        x = noise.float()
        b = x.shape[0]
        for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
            t = torch.full((b,), float(sigma), dtype=torch.float32,
                           device=x.device) * self.num_timesteps
            out = self._guided(x, t, guidance_scale, orthogonal, interval,
                               **kwargs).float()
            x = scheduler.step(out, x, sigma, sigma_next,
                               prediction_type=prediction_type,
                               generator=generator)
        return x.to(noise.dtype)
