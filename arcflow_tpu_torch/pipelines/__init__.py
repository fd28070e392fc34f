from .arcflux_pipeline import (ArcFluxPipeline, ArcQwenImagePipeline,
                               retrieve_raw_timesteps)
from .convert import jax_params_to_torch, load_jax_latent_diffusion

__all__ = ['ArcFluxPipeline', 'ArcQwenImagePipeline', 'jax_params_to_torch',
           'load_jax_latent_diffusion', 'retrieve_raw_timesteps']
