"""Config -> running training job.

Counterpart of ``arcflow_tpu/apis/train.py`` (``train_model``,
``ema_config_from_cfg``): build the model through ``MODELS`` on the
device, shard it over the config's mesh, build the optimizers and the
state, auto-resume from the latest checkpoint with the loader
fast-forwarded to the resumed step (the bucketized loader for a dataset of
more than one resolution bucket, as in JAX), add the hooks and run.

``parallel`` (``configs/flux/_mesh_train.py``, ``_multihost_train.py``):
``mesh`` over the ``data`` and ``fsdp`` axes (one -1 inferred from the
world size) and ``dcn_mesh`` lay the ranks out as JAX does
(``parallel/mesh.py:make_mesh``); the model is sharded over ``fsdp`` and
replicated over ``data`` (``parallel/fsdp.py:shard_model``), and each rank
trains on ``samples_per_gpu`` rows of a global batch of ``samples_per_gpu
x |data| x |fsdp|``. ``sp`` beside them (a 3-D mesh) cuts every
sequence of the trunks over the ranks of an sp group, which hold the same
rows, in the layout of ``parallel.sp_mode`` ('ulysses' by default, as in
JAX, or 'ring'): the model (student and tied teacher) gets the group's
``SequenceParallel`` state. ``pipe`` and ``expert`` beside ``data``
(``configs/flux/_pipeline_train.py``; ``fsdp`` 1) place the model's
stages and experts on their ranks (``parallel/model_parallel.py:
partition_model``, no FSDP2): the block stacks the pipe degree divides run
as ``parallel.pipeline`` pipelines of ``pipe_microbatches`` microbatches
and ``pipe_interleave`` chunks a stage, and the MoE layers' experts split
over ``expert``; the ranks along both axes hold the same rows. A mesh of
one device runs the same code (in a process group of one, started here and
ended on return). ``fsdp_axis`` is 'fsdp' or None (``_pipeline_train.py``:
nothing sharded over fsdp, whose size must then be 1). ``tensor`` beside
``data`` / ``fsdp`` (``tensor_axis='tensor'``, JAX ``apis/train.py:58-82``)
splits the blocks Megatron-style over each tensor group
(``parallel/tensor.py:partition_tensor``; a unit whose layers hold fewer
than ``min_shard_size`` weight elements stays whole, as JAX's rule keeps
such a leaf replicated), then FSDP2 shards each rank's parts over
``fsdp``; the ranks of a tensor group hold the same rows. ``tensor``
beside ``sp``, ``pipe`` or ``expert`` is refused by name (ROADMAP.md
queue A items 5.11, 5.12), as is the host offload of the cold state (the
H100 holds it).
"""

from __future__ import annotations

import importlib.util
import os
from typing import Optional

import torch
import torch.distributed as dist

import numpy as np

from ..config import Config
from ..data import (Prefetcher, build_bucketized_loader, build_dataloader,
                    build_dataset, collate, load_datalist)
from ..parallel.fsdp import shard_model
from ..parallel.model_parallel import model_axes, partition_model
from ..parallel.tensor import partition_tensor
from ..parallel.mesh import (SequenceParallel, batch_ranks, make_mesh,
                             set_sequence_parallel, setup_distributed)
from ..registry import MODELS
from ..runner import (CheckpointHook, CheckpointManager, EmaConfig,
                      EvalHook, IterBasedRunner, ProfilerHook,
                      QuartileLossLoggerHook, TrainState, build_hooks,
                      build_logger, build_optimizers, build_train_step,
                      count_params)
from ..runner.runner import to_device


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


def parallel_from_cfg(cfg: Config) -> Optional[dict]:
    """``make_mesh``'s arguments from ``cfg.parallel`` (None without a
    ``mesh``); what the port does not train with is refused by name."""
    parallel = dict(cfg.get('parallel') or {})
    if not parallel.get('mesh'):
        return None
    if parallel.get('tensor_axis') not in ('tensor', None):
        raise ValueError(f'parallel.tensor_axis must be "tensor" or None, '
                         f'got {parallel["tensor_axis"]!r}')
    axes = dict(parallel['mesh'])
    fsdp_axis = parallel.get('fsdp_axis', 'fsdp')
    if fsdp_axis not in ('fsdp', None):
        raise ValueError(f'parallel.fsdp_axis must be "fsdp" or None, got '
                         f'{fsdp_axis!r}')
    if fsdp_axis is None and axes.get('fsdp', 1) != 1:
        raise ValueError(f'parallel.fsdp_axis None shards nothing over '
                         f'fsdp, but the mesh has fsdp={axes["fsdp"]}')
    for key, axis in (('pipe_axis', 'pipe'), ('expert_axis', 'expert')):
        if parallel.get(key, axis) not in (axis, None):
            raise ValueError(f'parallel.{key} must be "{axis}" or None, got '
                             f'{parallel[key]!r}')
    if set(axes) <= {'sp'}:         # sp alone: every rank holds the batch
        axes = dict(data=1, **axes)
    return dict(axes=axes,
                dcn_axes=dict(parallel.get('dcn_mesh') or {}) or None,
                sp_mode=parallel.get('sp_mode', 'ulysses'),
                min_shard_size=parallel.get('min_shard_size', 2 ** 16),
                pipe_microbatches=parallel.get('pipe_microbatches'),
                pipe_interleave=parallel.get('pipe_interleave', 1) or 1)


def _test_set_cfg(test_cfg: dict, can_encode: bool = True) -> dict:
    """``data.test`` as the port's ``ImagePrompt`` takes it. The shipped
    test sets (``configs/{flux,qwen}/_data_test.py``) keep the reference's
    keys: ``cache_dir`` under ``data_root``, the datalist at
    ``cache_datalist_path``, and ``prompt_dataset_kwargs`` naming a hub
    dataset the reference downloads (the port reads local files only). A
    cache whose records cannot be read here (neither ``zstandard`` nor the
    native loader, ``data/_fastloader``, or the first record's file
    missing) leaves the datalist's prompts alone,
    which the model's text encoder embeds; without one
    (``can_encode=False``) that raises, naming what is missing."""
    cfg = dict(test_cfg)
    root = cfg.pop('data_root', None)
    cfg.pop('prompt_dataset_kwargs', None)
    if 'cache_datalist_path' in cfg:
        cfg.setdefault('datalist_path', cfg.pop('cache_datalist_path'))
    cache = cfg.get('cache_dir')
    if cache is None:
        return cfg
    if root is not None and not os.path.isabs(cache):
        cfg['cache_dir'] = cache = os.path.join(root, cache)
    datalist = load_datalist(cfg['datalist_path'])
    first = os.path.join(cache, f'{datalist[0]["name"]}.zst') \
        if datalist else None
    zstd = importlib.util.find_spec('zstandard') is not None
    if not zstd:
        from ..data import _fastloader
        zstd = _fastloader.get_fastloader() is not None
    if zstd and first and os.path.exists(first):
        return cfg
    if not can_encode:
        why = f'{first} is missing' if zstd else (
            f'zstandard is not installed and the native loader is not '
            f'there: {_fastloader.unavailable_reason()}')
        raise ValueError(f'the evaluation needs the cached embeds of '
                         f'data.test under {cache} ({why}) or a text_encoder '
                         f'in the model to embed its prompts')
    keep = ('type', 'latent_size', 'start_ind', 'end_ind', 'test_mode',
            'negative_prompt')
    return dict({k: v for k, v in cfg.items() if k in keep},
                prompts_path=cfg['datalist_path'])


def eval_batch_from_test(test_cfg: dict, num_samples: int, device,
                         can_encode: bool = True) -> dict:
    """``EvalHook``'s batch for an ``evaluation`` entry that gives none:
    the first ``num_samples`` items of the test set ``test_cfg``
    (``_test_set_cfg``): their prompts (``prompt``, for the CLIP score),
    their test noise and their cached embeds (``prompt_embed_kwargs``)
    where the cache can be read, else the prompts alone
    (``prompt_kwargs``) if the model can encode them (``can_encode``), on
    ``device``. The JAX package passes ``dict(num_samples=n)`` there,
    which its ``val_step`` cannot embed (ROADMAP.md queue C)."""
    dataset = build_dataset(_test_set_cfg(test_cfg, can_encode))
    rows = range(min(num_samples, len(dataset)))
    items = dataset.getitems(rows) if hasattr(dataset, 'getitems') \
        else [dataset[i] for i in rows]
    batch = collate(items)
    prompts = [str(p) for p in batch['name']]
    out = dict(prompt=prompts, noise=batch['noise'])
    if 'prompt_embed_kwargs' in batch:
        out['prompt_embed_kwargs'] = batch['prompt_embed_kwargs']
    else:
        out['prompt_kwargs'] = dict(prompt=prompts)
    return to_device(out, device)


def train_model(cfg: Config, work_dir: Optional[str] = None,
                resume: bool = True, seed: int = 0,
                max_iters: Optional[int] = None, device='cuda'):
    """Train ``cfg`` on ``device`` (the card unless the caller asks for the
    CPU), over the config's mesh where it has one; returns (state,
    model). Under ``torch.distributed`` (every rank calls it) each rank
    trains on its own card (``cuda:{LOCAL_RANK}``)."""
    mesh_args = parallel_from_cfg(cfg)
    device = torch.device(device)
    started = mesh_args is not None and not dist.is_initialized()
    if started:
        setup_distributed(device.type)
    try:
        if mesh_args is None and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise ValueError(f'{dist.get_world_size()} processes and no '
                             f'parallel.mesh: set one (e.g. data=-1)')
        pipe = {}
        if mesh_args is not None:
            pipe = dict(microbatches=mesh_args.pop('pipe_microbatches'),
                        interleave=mesh_args.pop('pipe_interleave'))
        sp_mode = None if mesh_args is None else mesh_args.pop('sp_mode')
        min_size = None if mesh_args is None \
            else mesh_args.pop('min_shard_size')
        mesh = None if mesh_args is None else make_mesh(**mesh_args)
        if device.type == 'cuda' and dist.is_initialized():
            device = torch.device('cuda', torch.cuda.current_device())
        return _train(cfg, work_dir, resume, seed, max_iters, device, mesh,
                      sp_mode, pipe, min_size)
    finally:
        if started:
            dist.destroy_process_group()


def _train(cfg, work_dir, resume, seed, max_iters, device, mesh,
           sp_mode=None, pipe=None, min_size=None):
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
    if mesh is not None and 'sp' in mesh.mesh_dim_names:
        set_sequence_parallel(model, SequenceParallel(mesh.get_group('sp'),
                                                      sp_mode))
    if model_axes(mesh):
        partition_model(model, mesh, **(pipe or {}))
    elif mesh is not None:
        if 'tensor' in mesh.mesh_dim_names:
            partition_tensor(model, mesh, min_size)
        shard_model(model, mesh)
    if mesh is not None:
        logger.info(f'mesh parallelism: '
                    f'{dict(zip(mesh.mesh_dim_names, mesh.shape))}'
                    + (f', sp_mode {sp_mode}' if 'sp' in mesh.mesh_dim_names
                       else '') + (f', pipe {pipe}' if 'pipe' in
                                   mesh.mesh_dim_names else '')
                    + (f', tensor min_shard_size {min_size}' if 'tensor' in
                       mesh.mesh_dim_names else ''))
    trainable, frozen = model.init_params()
    logger.info(f'trainable params: {count_params(trainable):,}; '
                f'frozen params: {count_params(frozen):,}')
    optimizers = build_optimizers(dict(cfg.optimizer), trainable)
    state = TrainState.create(torch.Generator(device).manual_seed(seed),
                              trainable, frozen, optimizers,
                              ema_keys=model.ema_keys)
    state.model_parallel = getattr(model, 'model_parallel', None)

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
        grad_accum_steps=grad_accum_steps, mesh=mesh)

    # samples_per_gpu is per rank, as in the reference's per-GPU loaders:
    # rank r of the batch ranks loads its rows of the global batch (those
    # of each micro-batch under accumulation, data.samplers.rank_rows)
    rank, num_replicas = batch_ranks(mesh) if mesh is not None else (0, 1)
    deal = dict(num_replicas=num_replicas, rank=rank)
    if grad_accum_steps > 1:
        deal['chunk'] = samples_per_gpu // grad_accum_steps
    # batches are staged on the rank's card by the loader's worker
    stage = device if device.type == 'cuda' else None
    dataset = build_dataset(data_cfg['train'])
    if getattr(dataset, 'bucket_ids', None) is not None and \
            len(np.unique(dataset.bucket_ids)) > 1:
        loader = build_bucketized_loader(
            dataset, samples_per_gpu, seed=seed, start_iter=state.step,
            device=stage, **deal)
    else:
        loader = Prefetcher(build_dataloader(
            dataset, samples_per_gpu, seed=seed, start_iter=state.step,
            **deal), device=stage)

    extra_hooks = [QuartileLossLoggerHook(
        total_timesteps=cfg.model.diffusion.get('num_timesteps', 1000)),
        CheckpointHook(manager)]
    eval_cfg = cfg.get('evaluation')
    if eval_cfg:
        for e_cfg in [eval_cfg] if isinstance(eval_cfg, dict) else eval_cfg:
            e_cfg = {k: v for k, v in dict(e_cfg).items() if k != 'type'}
            if e_cfg.get('batch') is None and data_cfg.get('test'):
                e_cfg['batch'] = eval_batch_from_test(
                    data_cfg['test'], e_cfg.get('num_samples', 64), device,
                    getattr(model, 'text_encoder', None) is not None)
            extra_hooks.append(EvalHook(**e_cfg))
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
