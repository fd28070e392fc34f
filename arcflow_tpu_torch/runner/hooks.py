"""Runner hooks: logging, section timers, loss quartiles, checkpoints,
evaluation samples and a profiler window.

Counterpart of ``arcflow_tpu/runner/hooks.py``. A hook reads the runner
(``iter``, ``total_iters``, ``state``, ``log_buffer``, ``work_dir``,
``logger``, ``timers``) after each iteration and around the run. The text
and JSON loggers read the log buffer's scalars on the host only on their
interval; the loss quartiles read the per-sample losses every iteration,
as in JAX. The tensorboard and wandb logger hooks, and EvalHook's image and
CLIP branch, are not ported. Over several ranks every hook runs on every
rank (the checkpoint and the evaluation gather the shards), and only rank
0 writes: the log lines, ``metrics.jsonl``, the evaluation samples and
the profiler trace.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..registry import HOOKS


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _scalars(log_buffer: dict) -> dict:
    """The log buffer's scalars as Python floats."""
    out = {}
    for k, v in log_buffer.items():
        if isinstance(v, torch.Tensor):
            if v.numel() == 1 and v.dim() == 0:
                out[k] = float(v)
        elif np.ndim(v) == 0:
            out[k] = float(v)
    return out


class IterTimer:
    """Wall-clock section timer (a context manager), enabled on demand."""

    def __init__(self, name: str = 'time', enabled: bool = False):
        self.name = name
        self.enabled = enabled
        self.times = []
        self._t0 = None

    def __enter__(self):
        if self.enabled:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled and self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def average(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    def reset(self):
        self.times = []


class IterTimers(dict):
    """Named section timers."""

    def add_timer(self, name: str = 'time', enabled: bool = False):
        self[name] = IterTimer(name, enabled=enabled)
        return self[name]

    def enable_all(self):
        for t in self.values():
            t.enabled = True

    def disable_all(self):
        for t in self.values():
            t.enabled = False


class Hook:
    priority = 50

    def before_run(self, runner):
        pass

    def after_train_iter(self, runner):
        pass

    def after_run(self, runner):
        pass


@HOOKS.register_module()
class TextLoggerHook(Hook):
    """Periodic log line with the mean iteration time, the ETA and the
    scalars of the log buffer."""

    def __init__(self, interval: int = 50, by_epoch: bool = False):
        self.interval = interval
        self._t_last = None
        self._iter_times = []

    def before_run(self, runner):
        self._t_last = time.perf_counter()

    def after_train_iter(self, runner):
        now = time.perf_counter()
        self._iter_times.append(now - self._t_last)
        self._t_last = now
        if len(self._iter_times) > 200:
            self._iter_times = self._iter_times[-100:]
        if runner.iter % self.interval != 0:
            return
        t_avg = float(np.mean(self._iter_times[-self.interval:]))
        eta = t_avg * (runner.total_iters - runner.iter)
        msg = ', '.join(f'{k}: {v:.4g}'
                        for k, v in sorted(_scalars(runner.log_buffer).items()))
        runner.logger.info(
            f'iter [{runner.iter}/{runner.total_iters}] '
            f'time: {t_avg:.4g}s, eta: {eta / 60:.1f}min, {msg}')


@HOOKS.register_module()
class JsonLoggerHook(Hook):
    """Appends each interval's scalars to ``work_dir/metrics.jsonl``."""

    def __init__(self, interval: int = 50):
        self.interval = interval
        self._fh = None

    def before_run(self, runner):
        if _rank() != 0:
            return
        os.makedirs(runner.work_dir, exist_ok=True)
        self._fh = open(os.path.join(runner.work_dir, 'metrics.jsonl'), 'a',
                        encoding='utf-8')

    def after_train_iter(self, runner):
        if runner.iter % self.interval != 0 or self._fh is None:
            return
        rec = {'iter': runner.iter, **_scalars(runner.log_buffer)}
        self._fh.write(json.dumps(rec) + '\n')
        self._fh.flush()

    def after_run(self, runner):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


@HOOKS.register_module()
class IterTimerHook(Hook):
    """Section timers: 'data' (fetch and move to the device) and 'step';
    with ``sync`` the runner synchronizes the card after each step, so
    'step' is the step's device time (a diagnostic mode: it stops the host
    from running ahead). Logged as ``time_data``, ``time_step`` and
    ``time_iter`` (the whole iteration, hooks included)."""

    priority = 30

    def __init__(self, interval: int = 50, sync: bool = True):
        self.interval = interval
        self.sync = sync
        self._t_iter_last = None
        self._iter_times = []

    def before_run(self, runner):
        runner.timers.enable_all()
        runner.sync_each_iter = runner.sync_each_iter or self.sync
        self._t_iter_last = time.perf_counter()

    def after_train_iter(self, runner):
        now = time.perf_counter()
        self._iter_times.append(now - self._t_iter_last)
        self._t_iter_last = now
        if runner.iter % self.interval != 0:
            return
        for name, timer in runner.timers.items():
            if timer.times:
                runner.log_buffer[f'time_{name}'] = timer.average()
                timer.reset()
        runner.log_buffer['time_iter'] = float(np.mean(self._iter_times))
        self._iter_times = []

    def after_run(self, runner):
        runner.timers.disable_all()
        runner.sync_each_iter = False


@HOOKS.register_module()
class QuartileLossLoggerHook(Hook):
    """EMA of the per-sample loss and variance by timestep quartile, with
    weight ``1 - exp(-momentum * count)`` per quartile; reads
    'per_sample_loss', 'per_sample_var' and 'timesteps' from the step's
    log dict."""

    def __init__(self, total_timesteps: int = 1000, momentum: float = 0.1,
                 prefix: str = 'loss'):
        self.total_timesteps = total_timesteps
        self.momentum = momentum
        self.prefix = prefix
        self.loss_q = np.zeros(4)
        self.var_q = np.ones(4)
        self.count_q = np.zeros(4, np.int64)

    def after_train_iter(self, runner):
        logs = runner.log_buffer
        if 'per_sample_loss' not in logs or 'timesteps' not in logs:
            return

        def host(x):
            return x.detach().float().cpu().numpy().reshape(-1) \
                if isinstance(x, torch.Tensor) else np.asarray(x).reshape(-1)
        loss, t = host(logs['per_sample_loss']), host(logs['timesteps'])
        if loss.shape[0] != t.shape[0]:
            return
        var = host(logs['per_sample_var']) if 'per_sample_var' in logs \
            else np.ones_like(loss)
        quart = np.clip((t / self.total_timesteps * 4).astype(int), 0, 3)
        for q in range(4):
            mask = quart == q
            n = int(mask.sum())
            if n == 0:
                continue
            cur_w = 1 - np.exp(-self.momentum * n)
            self.count_q[q] += n
            total_w = max(1 - np.exp(-self.momentum * self.count_q[q]), 1e-4)
            w = cur_w / total_w
            self.loss_q[q] = self.loss_q[q] * (1 - w) + loss[mask].mean() * w
            self.var_q[q] = self.var_q[q] * (1 - w) + var[mask].mean() * w
            runner.log_buffer[f'{self.prefix}_quartile_{q}'] = self.loss_q[q]


@HOOKS.register_module()
class EvalHook(Hook):
    """Every ``interval`` iterations, ``model.val_step`` on a fixed batch
    (by default ``num_samples`` draws of noise) with the EMA weights where
    the state has them: the samples go to ``work_dir/eval/iter_N.npz`` and
    their std to the log buffer as ``eval_sample_std``. The image branch
    (an image grid, the CLIP score) and the metrics (``latent_fd``) are not
    ported."""

    priority = 60

    def __init__(self, interval: int = 1000, batch: Optional[dict] = None,
                 num_samples: int = 64, val_kwargs: Optional[dict] = None,
                 metrics: Sequence[str] = (), clip_path: Optional[str] = None):
        if metrics or clip_path is not None:
            raise NotImplementedError(
                f'EvalHook metrics {tuple(metrics)}: the image, CLIP and '
                f'latent_fd branches are not ported (ROADMAP.md queue A '
                f'item 7)')
        self.interval = interval
        self.batch = batch
        self.num_samples = num_samples
        self.val_kwargs = dict(val_kwargs or {})

    def after_train_iter(self, runner):
        if runner.iter % self.interval != 0:
            return
        state = runner.state
        batch = self.batch if self.batch is not None \
            else dict(num_samples=self.num_samples)
        ema = state.ema.get('diffusion') if state.ema else None
        device = getattr(runner.model, 'device', 'cpu')
        generator = torch.Generator(device=device).manual_seed(runner.iter)
        out = runner.model.val_step(batch, generator, ema=ema,
                                    **self.val_kwargs)
        if isinstance(out, dict) and 'pred_imgs' in out:
            raise NotImplementedError('EvalHook: image samples are not '
                                      'ported (ROADMAP.md queue A item 7)')
        arr = (out['pred_latents'] if isinstance(out, dict) else out)
        arr = arr.detach().float().cpu().numpy()
        runner.log_buffer['eval_sample_std'] = float(arr.std())
        if _rank() != 0:
            return
        out_dir = os.path.join(runner.work_dir, 'eval')
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f'iter_{runner.iter}.npz'),
                 samples=arr)
        runner.logger.info(f'eval @ iter {runner.iter} written to {out_dir}')


@HOOKS.register_module()
class ProfilerHook(Hook):
    """A ``torch.profiler`` trace (CPU and, on the card, CUDA activity) of
    the iterations after ``start_iter`` up to ``start_iter + num_iters``,
    written as a Chrome trace to ``out_dir`` (``work_dir/profile`` by
    default)."""

    def __init__(self, start_iter: int = 10, num_iters: int = 5,
                 out_dir: Optional[str] = None):
        self.start_iter = start_iter
        self.stop_iter = start_iter + num_iters
        self.out_dir = out_dir
        self._prof = None
        self.trace_path = None

    def _stop(self, runner):
        self._prof.stop()
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        runner.logger.info(f'profiler trace written to {self.trace_path}')

    def after_train_iter(self, runner):
        if _rank() != 0:
            return
        if runner.iter == self.start_iter and self._prof is None:
            out = self.out_dir or os.path.join(runner.work_dir, 'profile')
            os.makedirs(out, exist_ok=True)
            self.trace_path = os.path.join(
                out, f'trace_iter{self.start_iter}-{self.stop_iter}.json')
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            runner.logger.info(f'profiler trace started -> {out}')
        elif runner.iter >= self.stop_iter and self._prof is not None:
            self._stop(runner)

    def after_run(self, runner):
        if self._prof is not None:
            self._stop(runner)


@HOOKS.register_module()
class CheckpointHook(Hook):
    """Drives a ``CheckpointManager`` on its interval and force-saves at the
    end of the run (the preemption flush)."""

    priority = 40

    def __init__(self, manager=None):
        self.manager = manager

    def after_train_iter(self, runner):
        if self.manager is not None:
            self.manager.save(runner.state)

    def after_run(self, runner):
        if self.manager is not None:
            self.manager.save(runner.state, force=True)
            self.manager.wait()


def build_logger(work_dir: Optional[str],
                 name: str = 'arcflow_tpu_torch') -> logging.Logger:
    """A logger to stdout and, once per process, to a timestamped file
    under ``work_dir``; on ranks other than 0, warnings to stdout only."""
    logger = logging.getLogger(name)
    logger.propagate = False
    if _rank() != 0:
        logger.setLevel(logging.WARNING)
        work_dir = None
    else:
        logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter('%(asctime)s %(levelname)s %(message)s')
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if work_dir:
            os.makedirs(work_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(
                work_dir, f'{time.strftime("%Y%m%d_%H%M%S")}.log'))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
