from .flux import ArcFluxTransformer2DModel
from .qwen import ArcQwenImageTransformer2DModel
from .qwen_vae import PretrainedVAEQwenImage
from .vae import PretrainedVAE

__all__ = ['ArcFluxTransformer2DModel', 'ArcQwenImageTransformer2DModel',
           'PretrainedVAE', 'PretrainedVAEQwenImage']
