from .base import Diffusion2D, Distillation2D
from .flux import ArcFluxTransformer2DModel, FluxTransformer2DModel
from .latent_diffusion import LatentDiffusionTextImage
from .qwen import ArcQwenImageTransformer2DModel
from .qwen_vae import PretrainedVAEQwenImage
from .toy import (SpectrumMLP, ToyArcFlowDenoiser, ToyGMFlowDenoiser,
                  ToyMLPDenoiser)
from .vae import PretrainedVAE

__all__ = ['ArcFluxTransformer2DModel', 'ArcQwenImageTransformer2DModel',
           'Diffusion2D', 'Distillation2D', 'FluxTransformer2DModel',
           'LatentDiffusionTextImage', 'PretrainedVAE',
           'PretrainedVAEQwenImage', 'SpectrumMLP', 'ToyArcFlowDenoiser',
           'ToyGMFlowDenoiser', 'ToyMLPDenoiser']
