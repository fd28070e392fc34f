"""Config -> running training job.

Counterpart of ``arcflow_tpu/apis/train.py`` (``train_model``,
``ema_config_from_cfg``): build the model through ``MODELS`` on the
device, the optimizers and the state, auto-resume from the latest
checkpoint with the loader fast-forwarded to the resumed step (the
bucketized loader for a dataset of more than one resolution bucket, as in
JAX), add the hooks and run. A ``parallel.mesh`` with an axis above 1 is
refused (the port's mesh training waits for its slice), as is the host
offload of the cold state (the H100 holds it).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

import numpy as np

from ..config import Config
from ..data import (Prefetcher, build_bucketized_loader, build_dataloader,
                    build_dataset)
from ..registry import MODELS
from ..runner import (CheckpointHook, CheckpointManager, EmaConfig,
                      EvalHook, IterBasedRunner, ProfilerHook,
                      QuartileLossLoggerHook, TrainState, build_hooks,
                      build_logger, build_optimizers, build_train_step,
                      count_params)


def build_model_from_cfg(cfg: Config, device='cuda'):
    return MODELS.build(cfg.model, default_args=dict(
        train_cfg=cfg.get('train_cfg'), test_cfg=cfg.get('test_cfg'),
        device=device))


def ema_config_from_cfg(cfg: Config) -> EmaConfig:
    """The EMA of the config's ExponentialMovingAverage hook, else the JAX
    default: a fixed momentum of 0.999."""
    for hook_cfg in cfg.get('custom_hooks', []) or []:
        if 'ExponentialMovingAverage' in hook_cfg.get('type', ''):
            return EmaConfig.from_hook_cfg(hook_cfg)
    return EmaConfig(momentum_policy='fixed', momentum=0.999)


def _check_parallel(cfg: Config):
    mesh = dict((cfg.get('parallel') or {}).get('mesh') or {})
    if any(v != 1 for v in mesh.values()):
        raise NotImplementedError(
            f'parallel.mesh {mesh}: the port trains on one device; its '
            f'data/fsdp/tensor mesh waits for ROADMAP.md queue A item 5 '
            f'(set every axis to 1, or drop parallel)')


def train_model(cfg: Config, work_dir: Optional[str] = None,
                resume: bool = True, seed: int = 0,
                max_iters: Optional[int] = None, device='cuda'):
    """Train ``cfg`` on ``device`` (the card unless the caller asks for the
    CPU); returns (state, model)."""
    _check_parallel(cfg)
    device = torch.device(device)
    work_dir = work_dir or cfg.get('work_dir', 'work_dirs/default')
    os.makedirs(work_dir, exist_ok=True)
    logger = build_logger(work_dir)
    cfg.dump(os.path.join(work_dir, 'config.py'))
    logger.info(f'device: {device}'
                + (f' ({torch.cuda.get_device_name(device)})'
                   if device.type == 'cuda' else ''))

    train_cfg = dict(cfg.get('train_cfg', {}) or {})
    if train_cfg.pop('offload_cold_state', False):
        raise NotImplementedError('train_cfg.offload_cold_state (TPU host '
                                  'offload) is not ported')
    torch.manual_seed(seed)
    model = build_model_from_cfg(cfg, device=device)
    trainable, frozen = model.init_params()
    logger.info(f'trainable params: {count_params(trainable):,}; '
                f'frozen params: {count_params(frozen):,}')
    optimizers = build_optimizers(dict(cfg.optimizer), trainable)
    state = TrainState.create(torch.Generator(device).manual_seed(seed),
                              trainable, frozen, optimizers,
                              ema_keys=model.ema_keys)

    ckpt_cfg = dict(cfg.get('checkpoint_config', {}) or {})
    out_dir = ckpt_cfg.pop('out_dir', os.path.join(work_dir, 'checkpoints'))
    manager = CheckpointManager(
        os.path.join(out_dir, cfg.get('name', 'default')),
        interval=ckpt_cfg.get('interval', 1000),
        must_save_interval=ckpt_cfg.get('must_save_interval'),
        max_keep_ckpts=ckpt_cfg.get('max_keep_ckpts'),
        ckpt_trainable_only=ckpt_cfg.get('trainable_only', True),
        ckpt_fp16=ckpt_cfg.get('fp16', False),
        ckpt_fp16_ema=ckpt_cfg.get('fp16_ema', False),
        ckpt_bf16_optim=ckpt_cfg.get('bf16_optim', False))
    if resume and manager.latest_step() is not None:
        manager.restore(state)
        logger.info(f'resumed from iter {state.step}')

    data_cfg = dict(cfg.data)
    samples_per_gpu = (data_cfg.get('train_dataloader', {}) or {}).get(
        'samples_per_gpu', data_cfg.get('samples_per_gpu', 1))
    grad_accum_steps = 1
    grad_accum_bs = train_cfg.get('grad_accum_batch_size')
    if grad_accum_bs:
        if samples_per_gpu % grad_accum_bs:
            raise ValueError(f'samples_per_gpu {samples_per_gpu} is not a '
                             f'multiple of grad_accum_batch_size '
                             f'{grad_accum_bs}')
        grad_accum_steps = samples_per_gpu // grad_accum_bs
    train_step = build_train_step(
        model, optimizers, train_cfg=train_cfg,
        ema_cfg=ema_config_from_cfg(cfg) if model.ema_keys else None,
        grad_accum_steps=grad_accum_steps)

    dataset = build_dataset(data_cfg['train'])
    if getattr(dataset, 'bucket_ids', None) is not None and \
            len(np.unique(dataset.bucket_ids)) > 1:
        loader = build_bucketized_loader(dataset, samples_per_gpu, seed=seed,
                                         start_iter=state.step)
    else:
        loader = Prefetcher(build_dataloader(
            dataset, samples_per_gpu, seed=seed, start_iter=state.step))

    extra_hooks = [QuartileLossLoggerHook(
        total_timesteps=cfg.model.diffusion.get('num_timesteps', 1000)),
        CheckpointHook(manager)]
    eval_cfg = cfg.get('evaluation')
    if eval_cfg:
        for e_cfg in [eval_cfg] if isinstance(eval_cfg, dict) else eval_cfg:
            extra_hooks.append(EvalHook(**{k: v for k, v in dict(e_cfg).items()
                                           if k != 'type'}))
    if cfg.get('profiler'):
        extra_hooks.append(ProfilerHook(**dict(cfg.profiler)))
    hooks = build_hooks(cfg.get('log_config'), extra_hooks=extra_hooks,
                        logger=logger)

    total = max_iters or cfg.get('total_iters', 10000)
    runner = IterBasedRunner(model, state, train_step, loader, total,
                             work_dir=work_dir, hooks=hooks, logger=logger,
                             gc_interval=cfg.get('gc_interval'),
                             device=device)
    try:
        state = runner.run()
    finally:
        loader.close()
        manager.close()
    return state, model
