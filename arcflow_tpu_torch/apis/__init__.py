from .inference import init_model
from .train import build_model_from_cfg, ema_config_from_cfg, train_model

__all__ = ['build_model_from_cfg', 'ema_config_from_cfg', 'init_model',
           'train_model']
