from .train import build_model_from_cfg, ema_config_from_cfg, train_model

__all__ = ['build_model_from_cfg', 'ema_config_from_cfg', 'train_model']
