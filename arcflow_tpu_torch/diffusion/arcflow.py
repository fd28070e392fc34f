"""ArcFlow few-step distillation: the segment loss, the data-based and the
data-free training losses, and sampling.

Counterpart of ``arcflow_tpu/diffusion/arcflow.py``: ``ArcFlowImitationBase``
(``make_policy``, ``piid_segment_momentum``, ``forward_test``),
``ArcFlowImitation`` (the data-based single-segment loss: ``sample_t``
snapped to the NFE grid, ``forward_train``, ``_teacher_ratio``),
``ArcFlowImitationDataFree`` (``forward_initialize`` and one NFE step per
``forward_train``) and ``multistep_train_loss``. The JAX package compiles
the NFE loop of ``forward_test`` as one ``lax.scan``; here it is a Python
loop over the same host-side raw-time grid.

Every random draw comes from one explicit ``torch.Generator``, in the order
the JAX module draws its keys' numbers. Data-based: the LoRA dropout seed
(only with ``lora_dropout``), t, the noise, then the segment's draws.
Data-free: the initial noise, then per NFE step the LoRA dropout seed, the
GM dropout mask, the student and the teacher interval draws. What the JAX
module wraps in ``stop_gradient`` runs under ``torch.no_grad`` or is
detached here: the policy the rollouts use, the rollout states, the
teacher's u and the state handed to the next NFE step (JAX
``arcflow.py:103,136-139,154,165``).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..registry import MODULES
from .gaussian_flow import GaussianFlow
from .integrator import momentum_integration, policy_average_u
from .policies.arcflow import ArcFlowPolicy

TeacherFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _seq_len_of(x: torch.Tensor) -> Optional[int]:
    """Token count for dynamic shifting: product of the non-batch,
    non-channel dims (channel-last layout)."""
    return math.prod(x.shape[1:-1]) if x.dim() > 2 else None


class ArcFlowImitationBase(GaussianFlow):
    """The segment distillation shared by the data-based and the data-free
    losses, around a denoiser ``nn.Module`` whose forward is
    ``denoising(x_t, t, **cond) -> {means, logweights, loggammas}``. Only
    the ArcFlow policy is ported."""

    def __init__(self, *args, policy_type: str = 'ArcFlow',
                 policy_kwargs: Optional[dict] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if policy_type != 'ArcFlow':
            raise ValueError(f'policy_type {policy_type!r}: only ArcFlow is '
                             f'ported')
        self.policy_kwargs = dict(policy_kwargs or {})

    def make_policy(self, denoising_output: dict, x_t_src: torch.Tensor,
                    sigma_t_src: torch.Tensor, eps: float = 1e-4
                    ) -> ArcFlowPolicy:
        return ArcFlowPolicy.create(denoising_output, x_t_src, sigma_t_src,
                                    eps=eps, **self.policy_kwargs)

    # ---- segment loss -------------------------------------------------------
    def piid_segment_momentum(self, generator: torch.Generator,
                              teacher_fn: TeacherFn, policy: ArcFlowPolicy,
                              x_t_src: torch.Tensor, raw_t_src: torch.Tensor,
                              sigma_t_src: torch.Tensor, teacher_ratio,
                              segment_size, get_x_t_dst: bool = False):
        """Distillation loss of one NFE segment: ``num_intermediate_states``
        interior times split between a student-rollout and a teacher-rollout
        portion (``teacher_ratio``), with a terminal window of
        ``window_substeps`` held out; at each the frozen teacher's u is the
        target of the student's mean velocity over the rest of the span, and
        x rolls on with the teacher's u. Returns (loss, log_info,
        x_t_dst or None, raw_t_dst)."""
        eps = self.train_cfg.get('eps', 1e-4)
        total_substeps = self.train_cfg.get('total_substeps', 128)
        n_states = self.train_cfg.get('num_intermediate_states', 2)
        window_substeps = self.train_cfg.get('window_substeps', 0)
        gm_dropout = self.train_cfg.get('gm_dropout', 0.0)

        dev, f32 = x_t_src.device, torch.float32
        bs = x_t_src.shape[0]
        seq_len = _seq_len_of(x_t_src)

        def warp(rt):
            return self.timestep_sampler.warp_t(rt, seq_len=seq_len)

        segment_size = torch.broadcast_to(
            torch.as_tensor(segment_size, dtype=f32, device=dev), (bs,))
        teacher_ratio = torch.as_tensor(teacher_ratio, dtype=f32, device=dev)

        # terminal hold-out window ~= window_substeps / total_substeps
        num_substeps = torch.clamp(torch.round(segment_size * total_substeps),
                                   min=1.0)
        substep_size = segment_size / num_substeps
        window_size = torch.minimum(window_substeps * substep_size,
                                    segment_size)
        raw_t_dst = raw_t_src - segment_size

        policy_detached = policy.detach()
        if gm_dropout > 0.0:
            policy_detached = policy_detached.dropout(generator, gm_dropout)

        # student-portion and teacher-portion interval draws
        free_span = segment_size - window_size                       # (B,)
        s_draw = torch.rand((bs, n_states), generator=generator, device=dev)
        s_draw = s_draw * ((1.0 - teacher_ratio) * free_span)[:, None]
        s_sorted = torch.sort(s_draw, dim=-1).values
        zeros = torch.zeros((bs, 1), dtype=f32, device=dev)
        student_intervals = torch.diff(s_sorted, dim=-1, prepend=zeros)
        t_draw = torch.rand((bs, n_states - 1), generator=generator,
                            device=dev)
        t_sorted = torch.sort(t_draw, dim=-1).values
        teacher_intervals = torch.diff(t_sorted, dim=-1, prepend=zeros,
                                       append=torch.ones_like(zeros))
        teacher_intervals = teacher_intervals * (
            teacher_ratio * free_span)[:, None]

        x_t = x_t_src
        raw_t = raw_t_src
        sigma_t = sigma_t_src.to(f32).reshape(bs)
        all_pred_u, all_tgt_u, all_t = [], [], []
        for i in range(n_states):
            raw_t_a = torch.clamp(raw_t - student_intervals[:, i], min=0.0)
            raw_t_b = torch.clamp(raw_t_a - teacher_intervals[:, i], min=0.0)
            sigma_t_a = warp(raw_t_a)
            t_a = sigma_t_a * self.num_timesteps
            with torch.no_grad():
                # detached student rollout to the teacher's query point
                x_t_a = momentum_integration(policy_detached, x_t, sigma_t,
                                             sigma_t_a, eps=eps)
                tgt_u = teacher_fn(x_t_a, t_a)
            all_tgt_u.append(tgt_u)
            all_t.append(t_a)

            # student mean u over [raw_t_a, raw_t_b - window] (not clamped
            # at 0, as in the reference)
            raw_t_end = raw_t_b - window_size
            all_pred_u.append(policy_average_u(
                policy, x_t_a, sigma_t_a, warp(raw_t_end), raw_t_a,
                raw_t_end, total_substeps, eps=eps))

            # roll x forward with the teacher's velocity
            sigma_t_b = warp(raw_t_b)
            ds = (sigma_t_b - sigma_t_a).reshape(bs, *((x_t.dim() - 1) * [1]))
            x_t = (x_t_a + tgt_u * ds).detach()
            raw_t = raw_t_b
            sigma_t = sigma_t_b

        loss, log_info = self.flow_loss(dict(
            u_t_pred=torch.cat(all_pred_u, dim=0),
            u_t=torch.cat(all_tgt_u, dim=0),
            timesteps=torch.cat(all_t, dim=0)))

        x_t_dst = None
        if get_x_t_dst:
            with torch.no_grad():
                x_t_dst = momentum_integration(policy_detached, x_t, sigma_t,
                                               warp(raw_t_dst), eps=eps)
        return loss, log_info, x_t_dst, raw_t_dst

    # ---- inference ----------------------------------------------------------
    @torch.no_grad()
    def forward_test(self, noise: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     test_cfg_override: Optional[dict] = None,
                     **kwargs) -> torch.Tensor:
        """NFE-step sampling from ``noise``: one DiT call plus closed-form
        integration per step; ``kwargs`` are the denoiser's conditioning.
        Deterministic: ``generator`` is unused."""
        cfg = copy.deepcopy(self.test_cfg)
        cfg.update(test_cfg_override or {})
        eps = cfg.get('eps', 1e-4)
        nfe = cfg['nfe']
        timestep_ratio = max(cfg.get('timestep_ratio', 1.0), eps)
        temperature = cfg.get('temperature', 1.0)
        base_segment_size = 1.0 / (nfe - 1 + timestep_ratio)

        b = noise.shape[0]
        seq_len = _seq_len_of(noise)
        x = noise.to(torch.float32)

        # host-side raw-time grid (final segment scaled by timestep_ratio)
        # and per-step temperatures (none on the final step)
        raw = [1.0]
        for step_id in range(nfe):
            seg = base_segment_size * (timestep_ratio
                                       if step_id == nfe - 1 else 1.0)
            raw.append(raw[-1] - seg)
        raw = np.asarray(raw, np.float32)
        temps = [temperature] * (nfe - 1) + [1.0]

        def sigma_at(r):
            raw_b = torch.full((b,), float(r), dtype=torch.float32,
                               device=x.device)
            return self.timestep_sampler.warp_t(raw_b, seq_len=seq_len)

        for step_id in range(nfe):
            sigma_t_src = sigma_at(raw[step_id])
            t_src = sigma_t_src * self.num_timesteps
            denoising_output = self.pred(x, t_src, **kwargs)
            policy = self.make_policy(denoising_output, x, sigma_t_src,
                                      eps=eps).temperature(temps[step_id])
            x = momentum_integration(policy, x, sigma_t_src,
                                     sigma_at(raw[step_id + 1]), eps=1e-4)
        return x.to(noise.dtype)


@MODULES.register_module()
class ArcFlowImitation(ArcFlowImitationBase):
    """Data-based single-segment distillation: each sample's segment of the
    NFE grid is drawn, x is noised to its source and the segment loss is
    taken there."""

    def sample_t(self, generator: torch.Generator, num_batches: int,
                 seq_len=None, device=None):
        """A random NFE-grid segment per sample, raw t snapped to its
        source: (raw_t_src, sigma_t_src, t_src, segment_size), each (B,)."""
        eps = self.train_cfg.get('eps', 1e-4)
        nfe = self.train_cfg['nfe']
        timestep_ratio = max(self.train_cfg.get('timestep_ratio', 1.0), eps)
        one_minus_final = 1.0 - timestep_ratio
        base_segment = 1.0 / (nfe - one_minus_final)
        final_segment = timestep_ratio * base_segment

        raw_t = self.timestep_sampler(generator, num_batches, warp_t=False,
                                      scale_t=False, device=device
                                      ).clamp_min(eps)
        idx = torch.clamp(torch.ceil(raw_t / base_segment + one_minus_final),
                          1, nfe)
        raw_t_src = torch.clamp((idx - one_minus_final) * base_segment, eps,
                                1.0)
        segment_size = torch.where(
            idx == 1, torch.full_like(raw_t, final_segment),
            torch.full_like(raw_t, base_segment))
        sigma_t_src = self.timestep_sampler.warp_t(raw_t_src, seq_len=seq_len)
        t_src = sigma_t_src * self.num_timesteps
        return raw_t_src, sigma_t_src, t_src, segment_size

    def forward_train(self, generator: torch.Generator, x_0: torch.Tensor,
                      teacher_fn: TeacherFn = None, running_status=None,
                      **kwargs):
        """The segment loss at a drawn NFE-grid segment of noised data;
        returns (loss, log_vars)."""
        seq_len = _seq_len_of(x_0)
        teacher_ratio, log_vars = self._teacher_ratio(running_status)
        dropout_seed = self._maybe_dropout_seed(generator)
        raw_t_src, sigma_t_src, t_src, segment_size = self.sample_t(
            generator, x_0.shape[0], seq_len=seq_len, device=x_0.device)
        noise = torch.randn(x_0.shape, generator=generator,
                            dtype=torch.float32, device=x_0.device)
        x_t_src = self.sample_forward_diffusion(x_0, t_src, noise)[0]
        denoising_output = self.pred(x_t_src, t_src,
                                     dropout_seed=dropout_seed, **kwargs)
        policy = self.make_policy(denoising_output, x_t_src, sigma_t_src)
        loss, log_info, _, _ = self.piid_segment_momentum(
            generator, teacher_fn, policy, x_t_src, raw_t_src, sigma_t_src,
            teacher_ratio, segment_size)
        log_vars.update(log_info)
        log_vars['loss_diffusion'] = loss.detach()
        return loss, log_vars

    def _teacher_ratio(self, running_status):
        """Linear decay of the teacher-rollout share over num_decay_iters."""
        num_decay_iters = self.train_cfg.get('num_decay_iters', 0)
        if num_decay_iters > 0:
            iteration = torch.tensor(float(running_status['iteration']))
            ratio = 1.0 - torch.clamp(iteration,
                                      max=num_decay_iters) / num_decay_iters
            return ratio, dict(teacher_ratio=ratio)
        return 0.0, {}


@MODULES.register_module()
class ArcFlowImitationDataFree(ArcFlowImitation):
    """Multi-step data-free distillation, the variant the FLUX and Qwen
    configs use: each ``forward_train`` call is one NFE step from the
    previous step's state; ``multistep_train_loss`` sums them into one
    loss."""

    is_multistep = True

    def forward_initialize(self, generator: torch.Generator,
                           x_0: torch.Tensor, running_status=None, **kwargs):
        """Step states seeded with pure noise at raw t = 1 (``x_0`` gives
        only the shape and device)."""
        teacher_ratio, log_vars = self._teacher_ratio(running_status)
        x_t_src = torch.randn(x_0.shape, generator=generator,
                              dtype=torch.float32, device=x_0.device)
        step_states = dict(
            step_id=0, terminate=False, teacher_ratio=teacher_ratio,
            x_t_src=x_t_src,
            raw_t_src=torch.ones((x_0.shape[0],), dtype=torch.float32,
                                 device=x_0.device))
        return step_states, log_vars

    def forward_train(self, generator: torch.Generator, x_0=None,
                      step_states: Optional[dict] = None,
                      teacher_fn: TeacherFn = None, running_status=None,
                      **kwargs):
        """One NFE step of the distillation; returns (loss, log_vars,
        new_step_states)."""
        if step_states is None:
            raise ValueError('data-free training needs the step states of '
                             'forward_initialize')
        step_id = step_states['step_id']
        x_t_src = step_states['x_t_src']
        raw_t_src = step_states['raw_t_src']
        seq_len = _seq_len_of(x_t_src)

        eps = self.train_cfg.get('eps', 1e-4)
        nfe = self.train_cfg['nfe']
        timestep_ratio = max(self.train_cfg.get('timestep_ratio', 1.0), eps)
        base_segment = 1.0 / (nfe - 1 + timestep_ratio)
        segment_size = base_segment * (timestep_ratio
                                       if step_id == nfe - 1 else 1.0)

        sigma_t_src = self.timestep_sampler.warp_t(raw_t_src, seq_len=seq_len)
        t_src = sigma_t_src * self.num_timesteps
        dropout_seed = self._maybe_dropout_seed(generator)
        denoising_output = self.pred(x_t_src, t_src,
                                     dropout_seed=dropout_seed, **kwargs)
        policy = self.make_policy(denoising_output, x_t_src, sigma_t_src)

        step_loss, log_info, x_t_dst, raw_t_dst = self.piid_segment_momentum(
            generator, teacher_fn, policy, x_t_src, raw_t_src, sigma_t_src,
            step_states['teacher_ratio'], segment_size, get_x_t_dst=True)

        # each NFE step's loss weighted by its segment size
        loss = step_loss * segment_size
        log_vars = {k: (v * segment_size if k == 'per_sample_loss' else v)
                    for k, v in log_info.items()}
        log_vars.update({'loss_diffusion': loss.detach(),
                         f'loss_diffusion_step{step_id}': step_loss.detach()})

        new_states = dict(step_states)
        if step_id < nfe - 1:
            new_states.update(step_id=step_id + 1, x_t_src=x_t_dst,
                              raw_t_src=raw_t_dst)
        else:
            new_states.update(terminate=True)
        return loss, log_vars, new_states


def multistep_train_loss(diffusion: GaussianFlow,
                         generator: torch.Generator, x_0: torch.Tensor,
                         teacher_fn: TeacherFn = None, running_status=None,
                         **kwargs):
    """Sum the per-NFE-step losses into one differentiable scalar:
    initialize, then ``forward_train`` until ``terminate``; a single-step
    module takes its plain ``forward_train``. Returns (loss, log_vars)."""
    if not getattr(diffusion, 'is_multistep', False):
        return diffusion.forward_train(
            generator, x_0, teacher_fn=teacher_fn,
            running_status=running_status, **kwargs)
    step_states, log_vars = diffusion.forward_initialize(
        generator, x_0, running_status=running_status, **kwargs)
    total_loss = 0.0
    while not step_states['terminate']:
        loss, lv, step_states = diffusion.forward_train(
            generator, step_states=step_states, teacher_fn=teacher_fn,
            running_status=running_status, **kwargs)
        total_loss = total_loss + loss
        log_vars.update(lv)
    log_vars['loss_diffusion'] = total_loss.detach()
    return total_loss, log_vars
