from .base import Diffusion2D, Distillation2D
from .flux import ArcFluxTransformer2DModel, FluxTransformer2DModel
from .latent_diffusion import LatentDiffusionTextImage
from .qwen import ArcQwenImageTransformer2DModel
from .qwen_text import Qwen25TextModel, load_qwen25_text_params
from .qwen_vae import PretrainedVAEQwenImage
from .text_encoders import (PretrainedFluxTextEncoder,
                            PretrainedQwenImageTextEncoder,
                            PretrainedStableDiffusion3TextEncoder)
from .toy import (SpectrumMLP, ToyArcFlowDenoiser, ToyGMFlowDenoiser,
                  ToyMLPDenoiser)
from .vae import PretrainedVAE, PretrainedVAEDecoder

__all__ = ['ArcFluxTransformer2DModel', 'ArcQwenImageTransformer2DModel',
           'Diffusion2D', 'Distillation2D', 'FluxTransformer2DModel',
           'LatentDiffusionTextImage', 'PretrainedFluxTextEncoder',
           'PretrainedQwenImageTextEncoder',
           'PretrainedStableDiffusion3TextEncoder', 'PretrainedVAE',
           'PretrainedVAEDecoder', 'PretrainedVAEQwenImage',
           'Qwen25TextModel', 'SpectrumMLP', 'ToyArcFlowDenoiser',
           'ToyGMFlowDenoiser', 'ToyMLPDenoiser', 'load_qwen25_text_params']
