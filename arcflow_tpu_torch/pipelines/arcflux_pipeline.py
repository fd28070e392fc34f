"""End-user 2-NFE text-to-image pipelines (FLUX, Qwen-Image) from prompt
embeds.

Counterpart of ``arcflow_tpu/pipelines/arcflux_pipeline.py``
(``retrieve_raw_timesteps``, ``ArcFluxPipeline`` with ``quantize_int8`` and
``quantize_int4``, ``ArcQwenImagePipeline``): nfe-step ArcFlow sampling
(one DiT call + closed-form momentum integration per step, temperature on
every step but the last) -> VAE decode. The kernels follow the device the
modules and inputs live on; the w8a8 and w4a8 modes are state of the
transformer's layers and the sequence-parallel layout (``shard``) state of
its trunk and attention modules; there is no process-wide serving,
quantization or mesh flag. Prompt encoding, ``from_pretrained``, adapter
loading and the mesh axes other than ``sp`` wait for their slices.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..diffusion import ArcFlowImitationDataFree, ContinuousTimeStepSampler
from ..parallel.mesh import (SequenceParallel, make_mesh,
                             set_sequence_parallel)


def retrieve_raw_timesteps(num_inference_steps: int,
                           total_substeps: int = 128,
                           timestep_ratio: float = 1.0):
    """(nfe, substeps, ratio) -> raw sigma grid + per-segment substep
    counts."""
    eps = 1e-4
    nfe = num_inference_steps
    ratio = max(timestep_ratio, eps)
    base = 1.0 / (nfe - 1 + ratio)
    raw = [1.0]
    substeps = []
    for i in range(nfe):
        seg = base * (ratio if i == nfe - 1 else 1.0)
        raw.append(max(raw[-1] - seg, 0.0))
        substeps.append(max(round(seg * total_substeps), 1))
    return np.asarray(raw, np.float32), substeps


class ArcFluxPipeline:
    """FLUX-family ArcFlow pipeline around a transformer and a VAE module."""

    family = 'flux'

    def __init__(self, transformer: nn.Module, vae: Optional[nn.Module] = None,
                 shift: float = 3.2, use_dynamic_shifting: bool = False,
                 nfe: int = 2, timestep_ratio: float = 1.0,
                 temperature: float = 1.0, guidance_scale: float = 3.5):
        self.transformer = transformer
        self.vae = vae
        self.guidance_scale = guidance_scale
        self.diffusion = ArcFlowImitationDataFree(
            denoising=transformer, num_timesteps=1,
            timestep_sampler=ContinuousTimeStepSampler(
                shift=shift, use_dynamic_shifting=use_dynamic_shifting),
            test_cfg=dict(nfe=nfe, timestep_ratio=timestep_ratio,
                          temperature=temperature))

    def prepare_latents(self, batch_size: int, height: int, width: int,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> torch.Tensor:
        """Gaussian latents (B, H/8, W/8, C) in fp32 from ``generator``."""
        p = self.transformer.patch_size
        channels = self.transformer.in_channels // (p * p)
        return torch.randn((batch_size, height // 8, width // 8, channels),
                           generator=generator, dtype=torch.float32,
                           device=device)

    def _check_not_quantized(self) -> None:
        from ..models.layers import LoRADense
        if any(isinstance(m, LoRADense) and m.is_quantized
               for m in self.transformer.modules()):
            raise ValueError('the transformer is already quantized')

    def quantize_int8(self, act_quant: bool = False,
                      min_size: int = 2 ** 16) -> int:
        """int8-quantize the transformer's big kernels in place, one scale
        per output channel (``utils/quantize.py:quantize_weights_int8``);
        ``act_quant=True`` (w8a8) also quantizes activations per token and
        runs an int8 x int8 -> int32 product. The ArcFlow adapter surface
        (heads, LoRA, ``norm_out``) stays as it is. Call after the weights
        are loaded; a quantized transformer is refused. Returns the number
        of quantized layers."""
        from ..utils.quantize import quantize_weights_int8
        self._check_not_quantized()
        return len(quantize_weights_int8(self.transformer, min_size=min_size,
                                         act_quant=act_quant))

    def quantize_int4(self, act_quant: bool = False,
                      min_size: int = 2 ** 16, group_size: int = 128
                      ) -> int:
        """int4-quantize the transformer's big kernels in place, with
        group-wise scales (``utils/quantize.py:quantize_weights_int4``);
        ``act_quant=True`` (w4a8) also quantizes activations per token and
        runs the grouped-matmul kernel. The ArcFlow adapter surface (heads,
        LoRA, ``norm_out``) stays as it is. Call after the weights are
        loaded; a quantized transformer is refused. Returns the number of
        quantized layers."""
        from ..utils.quantize import quantize_weights_int4
        self._check_not_quantized()
        return len(quantize_weights_int4(self.transformer, min_size=min_size,
                                         group_size=group_size,
                                         act_quant=act_quant))

    def shard(self, mesh_axes: Dict[str, int], sp_mode: str = 'ulysses',
              min_size: Optional[int] = None):
        """Serve one image across the ranks of a sequence-parallel group:
        ``mesh_axes={'sp': n}`` over the n processes started with
        ``parallel.setup_distributed`` (JAX ``shard``, lines 349-391, same
        default mode). Each rank keeps its shard of the image and text
        tokens; attention runs in ``sp_mode`` 'ulysses' (all-to-all to head
        shards, heads % n == 0) or 'ring' (K/V blocks rotate, one K4 hop per
        block). The weights stay replicated and the VAE decodes on every
        rank. Call it after quantizing; then every rank calls
        ``__call__`` with the same ``latents`` or generator seed and gets
        the same images. Other axes raise, and so does ``min_size`` (JAX's
        smallest array the weight-sharding axes cut: ``sp`` cuts none).
        Returns the mesh ({'sp': process group})."""
        if min_size is not None:
            raise NotImplementedError(
                'min_size sizes weight sharding, which waits for the fsdp and '
                'tensor axes (ROADMAP A12): with sp alone the weights stay '
                'replicated')
        mesh = make_mesh(dict(mesh_axes))
        group = mesh['sp']
        sp = None
        if group is not None and group.size() > 1:
            sp = SequenceParallel(group, sp_mode)
        set_sequence_parallel(self.transformer, sp)
        return mesh

    @torch.inference_mode()
    def __call__(self, prompt_embeds: Dict[str, torch.Tensor],
                 height: int = 1024, width: int = 1024,
                 num_inference_steps: Optional[int] = None,
                 timestep_ratio: Optional[float] = None,
                 temperature: Optional[float] = None,
                 guidance_scale: Optional[float] = None,
                 latents: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 output_type: str = 'np'):
        """Sample from ``prompt_embeds`` (the transformer's conditioning,
        on its device: {encoder_hidden_states, pooled_projections} for
        FLUX, {encoder_hidden_states, encoder_hidden_states_mask} for
        Qwen). A transformer with guidance embeds gets ``guidance_scale``
        unless the embeds carry ``guidance``; one without gets none.

        ``output_type``: 'np' -> {'images': (B, H, W, 3) numpy in [0, 1]},
        'pt' -> the same as a tensor on the device, 'latent' ->
        {'latents': (B, H/8, W/8, C)}.
        """
        embeds = dict(prompt_embeds)
        ref = next(iter(embeds.values()))
        bs = ref.shape[0]
        if latents is None:
            latents = self.prepare_latents(bs, height, width, generator,
                                           device=ref.device)
        gs = guidance_scale if guidance_scale is not None \
            else self.guidance_scale
        if getattr(self.transformer, 'guidance_embeds', False) and \
                'guidance' not in embeds:
            embeds['guidance'] = torch.full((bs,), gs, dtype=torch.float32,
                                            device=ref.device)

        override = {}
        if num_inference_steps is not None:
            override['nfe'] = num_inference_steps
        if timestep_ratio is not None:
            override['timestep_ratio'] = timestep_ratio
        if temperature is not None:
            override['temperature'] = temperature
        latents = self.diffusion.forward_test(
            latents, test_cfg_override=override, **embeds)
        if self.vae is None or output_type == 'latent':
            return dict(latents=latents)
        images = (self.vae.decode(latents) / 2 + 0.5).clamp(0.0, 1.0)
        if output_type == 'pt':
            return dict(images=images)
        return dict(images=images.cpu().numpy())


class ArcQwenImagePipeline(ArcFluxPipeline):
    """Qwen-Image-family ArcFlow pipeline: the same sampling; Qwen has no
    guidance embeds, and its prompt embeds carry the text mask
    ``encoder_hidden_states_mask`` through to the transformer."""

    family = 'qwen'
