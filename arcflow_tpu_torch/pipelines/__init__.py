from .arcflux_pipeline import (ArcFluxPipeline, ArcQwenImagePipeline,
                               retrieve_raw_timesteps)
from .convert import jax_params_to_torch

__all__ = ['ArcFluxPipeline', 'ArcQwenImagePipeline', 'jax_params_to_torch',
           'retrieve_raw_timesteps']
