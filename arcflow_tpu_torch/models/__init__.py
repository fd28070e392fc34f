from .flux import ArcFluxTransformer2DModel
from .vae import PretrainedVAE

__all__ = ['ArcFluxTransformer2DModel', 'PretrainedVAE']
