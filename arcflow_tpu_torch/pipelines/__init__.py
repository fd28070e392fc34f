from .arcflux_pipeline import (ArcFluxPipeline, ArcQwenImagePipeline,
                               retrieve_raw_timesteps)
from .convert import (diffusers_qwen_vae_to_torch, diffusers_to_torch,
                      diffusers_vae_to_torch, expand_proj_out_to_arc_heads,
                      fuse_lora, fuse_pretrained_loras, graft_pretrained,
                      jax_params_to_torch, load_jax_latent_diffusion,
                      load_safetensors_state, torch_to_diffusers)
from .loader import load_adapter_state, save_adapter_state

__all__ = ['ArcFluxPipeline', 'ArcQwenImagePipeline',
           'diffusers_qwen_vae_to_torch', 'diffusers_to_torch',
           'diffusers_vae_to_torch', 'expand_proj_out_to_arc_heads',
           'fuse_lora', 'fuse_pretrained_loras', 'graft_pretrained',
           'jax_params_to_torch', 'load_adapter_state',
           'load_jax_latent_diffusion', 'load_safetensors_state',
           'retrieve_raw_timesteps', 'save_adapter_state',
           'torch_to_diffusers']
