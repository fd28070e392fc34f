from .base import Diffusion2D, Distillation2D
from .class_image import LatentDiffusionClassImage
from .flux import ArcFluxTransformer2DModel, FluxTransformer2DModel
from .latent_diffusion import LatentDiffusionTextImage
from .qwen import ArcQwenImageTransformer2DModel, QwenImageTransformer2DModel
from .qwen_text import Qwen25TextModel, load_qwen25_text_params
from .qwen_vae import PretrainedVAEQwenImage
from .text_encoders import (PretrainedFluxTextEncoder,
                            PretrainedQwenImageTextEncoder,
                            PretrainedStableDiffusion3TextEncoder)
from .unet import (ARCUNET_ADAPTER_KEYS, ArcDenoisingUnetMod,
                   DenoisingUnetMod)
from .toy import (SpectrumMLP, ToyArcFlowDenoiser, ToyGMFlowDenoiser,
                  ToyMLPDenoiser)
from .vae import PretrainedVAE, PretrainedVAEDecoder, PretrainedVAEEncoder

__all__ = ['ARCUNET_ADAPTER_KEYS', 'ArcDenoisingUnetMod',
           'ArcFluxTransformer2DModel', 'ArcQwenImageTransformer2DModel',
           'DenoisingUnetMod', 'Diffusion2D', 'Distillation2D',
           'FluxTransformer2DModel', 'LatentDiffusionClassImage',
           'LatentDiffusionTextImage', 'PretrainedFluxTextEncoder',
           'PretrainedQwenImageTextEncoder',
           'PretrainedStableDiffusion3TextEncoder', 'PretrainedVAE',
           'PretrainedVAEDecoder', 'PretrainedVAEEncoder',
           'PretrainedVAEQwenImage', 'Qwen25TextModel',
           'QwenImageTransformer2DModel', 'SpectrumMLP', 'ToyArcFlowDenoiser',
           'ToyGMFlowDenoiser', 'ToyMLPDenoiser', 'load_qwen25_text_params']
