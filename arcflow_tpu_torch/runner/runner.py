"""Iteration-based training runner.

Counterpart of ``arcflow_tpu/runner/runner.py`` (``IterBasedRunner``,
``build_hooks``): the iteration loop with hook dispatch, the iteration
counted on the host (the state's step is read once, at the start), each
batch moved to the model's device, manual GC pacing (``gc_interval``) and
preemption: the first SIGTERM or SIGINT lets the current iteration finish,
then the hooks' ``after_run`` force-saves a checkpoint and the run returns;
a second signal restores the default disposition so a stuck save can still
be killed. The handlers are installed only on the main thread (Python
delivers signals there). Over several ranks the ranks agree on the stop
after every iteration (one all-reduce of the flag), so a signal to any
one of them stops all at the same iteration with one checkpoint.
"""

from __future__ import annotations

import gc
import inspect
import logging
import signal
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..registry import HOOKS
from .hooks import Hook, IterTimers, build_logger
from .train_state import TrainState


def to_device(batch, device):
    """A batch (nested dicts of numpy arrays or tensors) on ``device``;
    host numpy arrays go through pinned memory on the card. Arrays of
    strings or objects (the prompts a collated batch stacks) and other
    values stay as they are."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray) and batch.dtype.kind not in 'USO':
        batch = torch.from_numpy(batch)
        if batch.device.type != torch.device(device).type \
                and torch.device(device).type == 'cuda':
            batch = batch.pin_memory()
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    return batch


class IterBasedRunner:

    def __init__(self, model, state: TrainState,
                 train_step_fn: Callable,
                 data_iter: Iterable,
                 total_iters: int,
                 work_dir: str = 'work_dirs/default',
                 hooks: Sequence[Hook] = (),
                 logger=None,
                 gc_interval: Optional[int] = None,
                 device=None):
        self.model = model
        self.state = state
        self.train_step_fn = train_step_fn
        self.data_iter = data_iter
        self.total_iters = total_iters
        self.work_dir = work_dir
        self.logger = logger or build_logger(work_dir)
        self.device = torch.device(device if device is not None else
                                   getattr(model, 'device', 'cpu'))
        self._hooks = sorted(hooks, key=lambda h: h.priority)
        self.log_buffer: Dict[str, Any] = {}
        self._iter = int(state.step)
        self.gc_interval = gc_interval
        # section timers (IterTimerHook enables them): 'data' is the fetch
        # and the move to the device, 'step' the train step (with a device
        # sync when sync_each_iter)
        self.timers = IterTimers()
        self.timers.add_timer('data')
        self.timers.add_timer('step')
        self.sync_each_iter = False
        self.preempted = False

    @property
    def iter(self) -> int:
        return self._iter

    def call_hook(self, fn_name: str):
        for h in self._hooks:
            getattr(h, fn_name)(self)

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _any_rank_preempted(self) -> bool:
        """Whether any rank has been signalled (this one's flag alone in
        one process)."""
        if not (dist.is_initialized() and dist.get_world_size() > 1):
            return self.preempted
        flag = torch.tensor([float(self.preempted)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def run(self) -> TrainState:
        self.call_hook('before_run')
        self.logger.info(
            f'starting at iter {self._iter}, target {self.total_iters}')
        gc_was_enabled = gc.isenabled()
        if self.gc_interval:
            gc.collect()
            gc.disable()

        self.preempted = False
        prev_handlers = {}

        def on_signal(signum, frame):
            if self.preempted:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            self.preempted = True
            self.logger.warning(
                f'signal {signum}: finishing current iter, saving '
                f'checkpoint, exiting (signal again to force-kill)')

        if threading.current_thread() is threading.main_thread():
            for s in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[s] = signal.signal(s, on_signal)
        try:
            while self._iter < self.total_iters and not self.preempted:
                with self.timers['data']:
                    batch = to_device(next(self.data_iter), self.device)
                with self.timers['step']:
                    self.state, logs = self.train_step_fn(self.state, batch)
                    if self.sync_each_iter:
                        self._sync()
                self._iter += 1
                self.log_buffer = dict(logs)
                self.call_hook('after_train_iter')
                if self.gc_interval and self._iter % self.gc_interval == 0:
                    gc.collect()
                self.preempted = self._any_rank_preempted()
        finally:
            if self.gc_interval and gc_was_enabled:
                gc.enable()
            # CheckpointHook.after_run force-saves at the current iteration
            # and joins the write: the preemption flush
            self.call_hook('after_run')
            for s, h in prev_handlers.items():
                signal.signal(s, h)
        if self.preempted:
            self.logger.warning(
                f'preempted at iter {self._iter}; checkpoint flushed')
        return self.state


def build_hooks(log_config: Optional[dict] = None, extra_hooks: Sequence = (),
                logger=None) -> list:
    """Hooks from a ``log_config`` (``interval`` and ``hooks``, each a
    ``HOOKS`` config) plus ``extra_hooks``. Every key a hook's
    ``__init__`` takes is passed; an unknown hook type and the keys a hook
    does not take are warned about, never dropped silently."""
    logger = logger or logging.getLogger('arcflow_tpu_torch')
    hooks = []
    if log_config:
        interval = log_config.get('interval', 50)
        for h_cfg in log_config.get('hooks', []):
            h_cfg = dict(h_cfg)
            h_type = h_cfg.pop('type')
            if h_type not in HOOKS:
                logger.warning(f'unknown hook type {h_type!r} skipped')
                continue
            cls = HOOKS.get(h_type)
            h_cfg.setdefault('interval', interval)
            sig = inspect.signature(cls.__init__)
            if not any(p.kind == inspect.Parameter.VAR_KEYWORD
                       for p in sig.parameters.values()):
                dropped = sorted(k for k in h_cfg if k not in sig.parameters)
                if dropped:
                    logger.warning(f'{h_type}: unsupported config keys '
                                   f'{dropped} dropped')
                h_cfg = {k: v for k, v in h_cfg.items()
                         if k in sig.parameters}
            hooks.append(cls(**h_cfg))
    hooks.extend(extra_hooks)
    return hooks
