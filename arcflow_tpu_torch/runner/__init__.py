"""Training runner: optimizers, EMA, the train step, checkpoints, hooks and
the iteration loop."""

from .checkpoint import CheckpointManager, load_raw_checkpoint
from .ema import EmaConfig, ema_momentum, ema_update
from .hooks import (CheckpointHook, EvalHook, Hook, IterTimer, IterTimerHook,
                    IterTimers, JsonLoggerHook, ProfilerHook,
                    QuartileLossLoggerHook, TensorboardLoggerHook,
                    TextLoggerHook, WandbLoggerHook, build_logger)
from .optim import (GradClipConfig, build_optimizers, clip_and_skip,
                    global_norm)
from .runner import IterBasedRunner, build_hooks
from .train_state import TrainState, count_params
from .train_step import build_train_step

__all__ = ['CheckpointHook', 'CheckpointManager', 'EmaConfig', 'EvalHook',
           'GradClipConfig', 'Hook', 'IterBasedRunner', 'IterTimer',
           'IterTimerHook', 'IterTimers', 'JsonLoggerHook', 'ProfilerHook',
           'QuartileLossLoggerHook', 'TensorboardLoggerHook',
           'TextLoggerHook', 'TrainState', 'WandbLoggerHook',
           'build_hooks', 'build_logger', 'build_optimizers',
           'build_train_step', 'clip_and_skip', 'count_params',
           'ema_momentum', 'ema_update', 'global_norm',
           'load_raw_checkpoint']
