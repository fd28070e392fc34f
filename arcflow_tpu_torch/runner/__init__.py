from .ema import EmaConfig, ema_momentum, ema_update
from .optim import (GradClipConfig, build_optimizers, clip_and_skip,
                    global_norm)
from .train_state import TrainState, count_params
from .train_step import build_train_step

__all__ = ['EmaConfig', 'GradClipConfig', 'TrainState', 'build_optimizers',
           'build_train_step', 'clip_and_skip', 'count_params',
           'ema_momentum', 'ema_update', 'global_norm']
