"""End-user 2-NFE text-to-image pipelines (FLUX, Qwen-Image).

Counterpart of ``arcflow_tpu/pipelines/arcflux_pipeline.py``
(``retrieve_raw_timesteps``, ``ArcFluxPipeline`` with ``from_pretrained``,
``load_arcflow_adapter``, ``quantize_int8``, ``quantize_int4``, ``shard``
and ``encode_prompt``, ``ArcQwenImagePipeline``): prompt encoding ->
nfe-step ArcFlow sampling (one DiT call + closed-form momentum integration
per step, temperature on every step but the last) -> VAE decode. The
kernels follow the device the modules and inputs live on; the w8a8 and
w4a8 modes are state of the transformer's layers and the sequence-parallel
layout (``shard``) state of its trunk and attention modules; there is no
process-wide serving, quantization or mesh flag. ``from_pretrained`` reads
diffusers folders (a transformer folder, local or behind a remote URI of
``utils/io_utils``, or a whole local pipeline folder with
``model_index.json``); ``shard`` serves over ``data``, ``fsdp``, ``sp``,
``tensor``, ``pipe`` and ``expert``.
"""

from __future__ import annotations

import inspect
import json
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..diffusion import ArcFlowImitationDataFree, ContinuousTimeStepSampler
from ..parallel.mesh import (SequenceParallel, ServingRows, make_mesh,
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
                 text_encoder=None, shift: float = 3.2,
                 use_dynamic_shifting: bool = False, nfe: int = 2,
                 timestep_ratio: float = 1.0, temperature: float = 1.0,
                 total_substeps: int = 128, guidance_scale: float = 3.5,
                 base_shift: float = 0.5, max_shift: float = 1.15,
                 base_image_seq_len: int = 256,
                 max_image_seq_len: int = 4096):
        """``base_shift`` .. ``max_image_seq_len`` are the dynamic shift's
        fields of a diffusers ``scheduler_config.json`` (log shifts at two
        image token counts; FLUX.1-dev's values by default)."""
        self.transformer = transformer
        self.vae = vae
        self.text_encoder = text_encoder
        self.rows = None            # the batch ranks' rows (``shard``)
        self.guidance_scale = guidance_scale
        self.diffusion = ArcFlowImitationDataFree(
            denoising=transformer, num_timesteps=1,
            timestep_sampler=ContinuousTimeStepSampler(
                shift=shift, use_dynamic_shifting=use_dynamic_shifting,
                base_logshift=base_shift, max_logshift=max_shift,
                base_seq_len=base_image_seq_len,
                max_seq_len=max_image_seq_len),
            test_cfg=dict(nfe=nfe, timestep_ratio=timestep_ratio,
                          temperature=temperature,
                          total_substeps=total_substeps))

    # ---- loading -----------------------------------------------------------
    @classmethod
    def from_pretrained(cls, model_dir: str, transformer_cls=None,
                        device='cuda', dtype=torch.bfloat16, **kwargs):
        """Build from a diffusers folder (JAX ``from_pretrained``): a
        transformer folder (``config.json`` + safetensors, sharded or
        not) loads the DiT and takes the rest from ``kwargs``; a pipeline
        folder (``model_index.json``) assembles every component
        (``_from_pipeline_folder``). The transformer's class comes from
        ``transformer_cls``, else the config's ``_class_name``, else
        ArcFlux; only its constructor's fields are read from
        the config. It is built on ``device`` in ``dtype`` (the heads stay
        fp32). A teacher-only folder's ``proj_out`` is expanded into the
        K-way means head. More than 10% of the model's keys missing, or
        any shape mismatch, raises (a folder of the other family); a key
        the model has no place for raises too, except the LoRA leaves of
        layers built without LoRA, which are fused into their weights. The
        few missing keys keep their init: the adapter brings them. A remote
        URI (``huggingface://org/repo``, ``s3://``; ``utils/io_utils``)
        names a transformer folder; a remote pipeline folder is refused, as
        in JAX."""
        from .. import models
        from ..utils.io_utils import get_file_backend, uri_scheme
        from .convert import (diffusers_to_torch,
                              expand_proj_out_to_arc_heads,
                              load_safetensors_state)
        if uri_scheme(model_dir) != 'local':
            # a remote transformer folder (JAX lines 126-140): config.json
            # and the weights through the scheme's backend
            backend = get_file_backend(model_dir)
            if backend.exists(backend.join_path(model_dir,
                                                'model_index.json')):
                raise NotImplementedError(
                    f'{model_dir} is a full pipeline folder (model_index.'
                    f'json): assembling one needs a local folder; download '
                    f'it and pass its path. Remote URIs load transformer '
                    f'folders only, as in JAX.')
            cfg_uri = backend.join_path(model_dir, 'config.json')
            cfg = json.loads(backend.get(cfg_uri)) \
                if backend.exists(cfg_uri) else {}
        elif os.path.exists(os.path.join(model_dir, 'model_index.json')):
            return cls._from_pipeline_folder(
                model_dir, transformer_cls=transformer_cls, device=device,
                dtype=dtype, **kwargs)
        else:
            cfg = _read_json(os.path.join(model_dir, 'config.json'))
        # the weights first: a folder without them fails before a model of
        # the default (12B) size is built
        raw = load_safetensors_state(model_dir)
        if transformer_cls is None and cfg.get('_class_name'):
            transformer_cls = getattr(models, cfg['_class_name'], None)
        transformer_cls = transformer_cls or models.ArcFluxTransformer2DModel
        fields = _init_fields(transformer_cls)
        cfg = {k: tuple(v) if isinstance(v, list) else v
               for k, v in cfg.items()
               if not k.startswith('_') and k in fields
               and k not in ('device', 'dtype')}
        model = transformer_cls(device=device, dtype=dtype, **cfg).eval()
        family = model.family
        state, _ = diffusers_to_torch(
            raw,
            len(getattr(model, 'joint_blocks', None)
                or model.transformer_blocks),
            len(getattr(model, 'single_blocks', ())),
            family=family, patch_size=model.patch_size)
        if getattr(model, 'num_gaussians', 0):
            state = expand_proj_out_to_arc_heads(
                state, model.num_gaussians, model.patch_size,
                generator=torch.Generator().manual_seed(0))
        expected = model.state_dict()
        bad = [f'{k}: ckpt {tuple(v.shape)} vs model '
               f'{tuple(expected[k].shape)}' for k, v in state.items()
               if k in expected and v.shape != expected[k].shape]
        missing = sorted(set(expected) - set(state))
        if bad or len(missing) > 0.1 * len(expected):
            raise ValueError(
                f'checkpoint at {model_dir} does not match the {family!r} '
                f'key maps / {type(model).__name__} structure: '
                f'{len(missing)}/{len(expected)} model params missing (e.g. '
                f'{missing[:3]}); shape mismatches: {bad[:3]} — wrong '
                f'pipeline family for this folder?')
        merge_state(model, state)
        return cls(model, **kwargs)

    @classmethod
    def _from_pipeline_folder(cls, root: str, transformer_cls=None,
                              text_encoder_kwargs: Optional[dict] = None,
                              vae_kwargs: Optional[dict] = None,
                              device='cuda', dtype=torch.bfloat16, **kwargs):
        """One call from a diffusers pipeline folder (JAX
        ``_from_pipeline_folder``): ``model_index.json`` names the
        components; the VAE and the text towers (with their ``tokenizer*``
        folders) are built from their subfolders, the transformer from
        ``transformer/``, and every field of ``scheduler/
        scheduler_config.json`` sets the timestep sampler: ``shift``,
        ``use_dynamic_shifting``, and ``base_shift``, ``max_shift``,
        ``base_image_seq_len``, ``max_image_seq_len`` for the dynamic
        shift. Explicit keyword arguments win over the folder's values,
        field by field. (JAX reads ``shift`` and ``use_dynamic_shifting``
        only, and neither when ``shift=`` is passed.)"""
        index = _read_json(os.path.join(root, 'model_index.json'))

        def sub(name):
            d = os.path.join(root, name)
            return d if name in index and os.path.isdir(d) else None

        sched = sub('scheduler')
        if sched is not None:
            scfg = _read_json(os.path.join(sched, 'scheduler_config.json'))
            for field in SCHEDULER_FIELDS:
                if field in scfg:
                    kwargs.setdefault(field, scfg[field])
        vae_dir = sub('vae')
        if vae_dir is not None and 'vae' not in kwargs:
            kwargs['vae'] = cls._load_vae_folder(
                vae_dir, (index.get('vae') or (None, ''))[1] or '',
                device=device, dtype=dtype, **(vae_kwargs or {}))
        if sub('text_encoder') is not None and 'text_encoder' not in kwargs:
            kwargs['text_encoder'] = cls._build_text_encoder(
                root, index, device=device, dtype=dtype,
                **(text_encoder_kwargs or {}))
        return cls.from_pretrained(os.path.join(root, 'transformer'),
                                   transformer_cls=transformer_cls,
                                   device=device, dtype=dtype, **kwargs)

    @staticmethod
    def _load_vae_folder(vae_dir: str, class_name: str = '', device='cuda',
                         dtype=torch.bfloat16, **overrides) -> nn.Module:
        """The VAE of a diffusers ``vae/`` folder, its ``config.json``
        giving the architecture and latent normalisation (JAX
        ``_load_vae_folder``): the Wan VAE for a QwenImage / Wan class
        name, else AutoencoderKL."""
        from ..models import PretrainedVAE, PretrainedVAEQwenImage
        cfg = _read_json(os.path.join(vae_dir, 'config.json'))
        if 'QwenImage' in class_name or 'Wan' in class_name:
            vae_cls, keys = PretrainedVAEQwenImage, (
                'base_dim', 'z_dim', 'dim_mult', 'num_res_blocks',
                'latents_mean', 'latents_std')
        else:
            vae_cls, keys = PretrainedVAE, (
                'latent_channels', 'block_out_channels', 'layers_per_block',
                'scaling_factor', 'shift_factor', 'latents_mean',
                'latents_std', 'use_post_quant_conv')
        args = {k: cfg[k] for k in keys if k in cfg and cfg[k] is not None}
        return vae_cls(from_pretrained=vae_dir, device=device, dtype=dtype,
                       **{**args, **overrides}).eval()

    @staticmethod
    def _build_text_encoder(root: str, index: dict, **overrides):
        """The text towers of a pipeline folder's ``text_encoder*`` and
        ``tokenizer*`` subfolders (JAX ``_build_text_encoder``); they load
        on the first encode."""
        from ..models import (PretrainedFluxTextEncoder,
                              PretrainedQwenImageTextEncoder)
        name = (index.get('text_encoder') or (None, ''))[1] or ''
        if name.startswith('Qwen'):
            return PretrainedQwenImageTextEncoder(
                pretrained=os.path.join(root, 'text_encoder'),
                tokenizer_path=os.path.join(root, 'tokenizer'), **overrides)
        return PretrainedFluxTextEncoder(
            clip_path=os.path.join(root, 'text_encoder'),
            t5_path=os.path.join(root, 'text_encoder_2'),
            clip_tokenizer_path=os.path.join(root, 'tokenizer'),
            t5_tokenizer_path=os.path.join(root, 'tokenizer_2'), **overrides)

    def load_arcflow_adapter(self, adapter_path: str) -> Optional[dict]:
        """Merge an exported ArcFlow adapter (heads, ``norm_out``, LoRA)
        into the transformer (JAX ``load_arcflow_adapter``) and update the
        sampling config from its ``policy_config`` (nfe, timestep_ratio,
        total_substeps, temperature). LoRA leaves of layers built without
        LoRA are fused into their weights (JAX keeps them in the tree,
        where a model without LoRA never reads them). Call before
        quantizing. Returns the policy config."""
        from .loader import load_adapter_state
        self._check_not_quantized()
        adapter, policy_config = load_adapter_state(
            adapter_path, family=self.transformer.family)
        merge_state(self.transformer, adapter)
        if policy_config:
            self.diffusion.test_cfg.update(
                {k: v for k, v in policy_config.items()
                 if k in ('nfe', 'timestep_ratio', 'total_substeps',
                          'temperature')})
        return policy_config

    def prepare_latents(self, batch_size: int, height: int, width: int,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> torch.Tensor:
        """Gaussian latents (B, H/8, W/8, C) in fp32 from ``generator``."""
        p = self.transformer.patch_size
        channels = self.transformer.out_channels // (p * p)
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
        """Serve across the ranks of a mesh (JAX ``shard``, lines 349-391:
        ``pipe.shard({'sp': 4, 'tensor': 2})``, ``{'fsdp': 4, 'tensor':
        2}``), over the processes started with
        ``parallel.setup_distributed``, the ranks in JAX's device order
        (``parallel.mesh.make_mesh(..., serving=True)``).

        * ``data`` and ``fsdp``: the batch is cut over the data x fsdp
          ranks (JAX ``batch_axes``; ``parallel.mesh.ServingRows``: a
          batch they do not divide, as batch 1, runs whole on every rank)
          and every rank returns the whole batch. With ``fsdp`` above 1
          the transformer's blocks, its other children and itself are
          FSDP2 units sharded over ``fsdp`` (``parallel/fsdp.py:
          shard_units``): a rank holds 1 / fsdp of the weights, quantized
          kernels included, and gathers a unit's before its forward and
          frees them after it;
        * ``sp``: each rank keeps its shard of the image and text tokens;
          attention runs in ``sp_mode`` 'ulysses' (all-to-all to head
          shards; the heads a rank holds must divide by sp) or 'ring' (K/V
          blocks rotate, one K4 hop per block);
        * ``tensor``: the blocks are split Megatron-style over each tensor
          group (``parallel/tensor.py``): each rank holds H / t heads and
          F / t hidden units of every split layer, and 1 / t of its
          weights. A unit whose layers hold fewer than ``min_size`` weight
          elements (JAX's default 2^16) stays whole, as JAX's rule keeps
          such a leaf replicated. The embedders, heads and VAE stay whole.
          Beside ``fsdp`` an fsdp shard is a shard of this rank's part;
        * ``pipe``: a rank holds its stage's blocks and frees the others
          (``parallel/model_parallel.py:partition_model``), and each NFE
          runs the stacks the pipe degree divides as a forward-only
          pipeline (``parallel/pipeline.py:pipeline_run``);
        * ``expert``: a rank holds E / n experts of every MoE layer and the
          combine is all-reduced over the group (``parallel/expert.py``).

        ``sp`` and ``tensor`` serve beside ``data`` / ``fsdp``, ``pipe``
        and ``expert`` beside ``data`` and each other. Refused by name,
        with their ROADMAP.md queue A items: ``sp`` beside ``pipe`` /
        ``expert`` (5.8), ``fsdp`` above 1 beside them (5.10), ``tensor``
        beside them (5.12), MoE blocks under ``tensor`` (5.13).

        Call it after quantizing (a quantized layer is split or sharded,
        never re-quantized), once (only an ``sp`` layout may be set
        again). Then every rank calls ``__call__`` with
        the same ``latents`` or generator seed and gets the same images.
        Returns the mesh: {axis: process group} for ``sp`` / ``tensor``
        alone, else the ``DeviceMesh``.
        """
        from ..models.layers import JointAttention
        from ..parallel.fsdp import shard_units
        from ..parallel.model_parallel import model_axes, partition_model
        from ..parallel.tensor import (TensorGroup, check_ulysses_heads,
                                       set_tensor_parallel)
        if any(getattr(m, 'tensor_split', None) is not None
               for m in self.transformer.modules()):
            raise ValueError('the transformer is split over tensor already')
        if self.rows is not None:
            raise ValueError('the transformer is placed on a mesh already')
        mesh = make_mesh(dict(mesh_axes), serving=True)
        device_mesh = None if isinstance(mesh, dict) else mesh
        if device_mesh is None:
            group, tgroup = mesh.get('sp'), mesh.get('tensor')
        else:
            names = device_mesh.mesh_dim_names
            group, tgroup = [device_mesh.get_group(a) if a in names else None
                             for a in ('sp', 'tensor')]
        sp = SequenceParallel(group, sp_mode) \
            if group is not None and group.size() > 1 else None
        tp = TensorGroup(tgroup) if tgroup is not None else None
        if sp is not None and tp is not None and sp_mode == 'ulysses':
            heads = next(m.num_heads for m in self.transformer.modules()
                         if isinstance(m, JointAttention))
            check_ulysses_heads(heads, tp.size, sp.size)
        if tp is not None:
            set_tensor_parallel(self.transformer, tp,
                                2 ** 16 if min_size is None else min_size)
        set_sequence_parallel(self.transformer, sp)
        if device_mesh is not None:
            if model_axes(device_mesh):
                partition_model(self.transformer, device_mesh)
            elif device_mesh.size(names.index('fsdp')) > 1:
                # serving takes no gradient, and FSDP2 wants one dtype
                # among a unit's trainable parameters (a bf16 trunk keeps
                # fp32 heads and LoRA): every parameter is frozen first
                self.transformer.requires_grad_(False)
                shard_units(self.transformer, device_mesh['data', 'fsdp']
                            if device_mesh.ndim > 2 else device_mesh)
            self.rows = ServingRows(device_mesh)
        return mesh

    def encode_prompt(self, prompt: Union[str, Sequence[str]]
                      ) -> Dict[str, torch.Tensor]:
        """The text encoder's conditioning for ``prompt`` (one or a list)."""
        if self.text_encoder is None:
            raise ValueError('pass prompt_embeds, or build the pipeline with '
                             'a text_encoder')
        return self.text_encoder([prompt] if isinstance(prompt, str)
                                 else list(prompt))

    @torch.inference_mode()
    def __call__(self, prompt: Union[str, Sequence[str], None] = None,
                 prompt_embeds: Optional[Dict[str, torch.Tensor]] = None,
                 height: int = 1024, width: int = 1024,
                 num_inference_steps: Optional[int] = None,
                 timestep_ratio: Optional[float] = None,
                 temperature: Optional[float] = None,
                 guidance_scale: Optional[float] = None,
                 latents: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 output_type: str = 'np'):
        """Sample from ``prompt`` through the text encoder, or from
        ``prompt_embeds`` (the transformer's conditioning, on its device:
        {encoder_hidden_states, pooled_projections} for FLUX,
        {encoder_hidden_states, encoder_hidden_states_mask} for Qwen). The
        latents come from ``latents`` or ``generator`` (JAX's ``seed=`` has
        no bitwise counterpart across the two RNGs). A transformer with
        guidance embeds gets ``guidance_scale`` unless the embeds carry
        ``guidance``; one without gets none.

        ``output_type``: 'np' -> {'images': (B, H, W, 3) numpy in [0, 1]},
        'pt' -> the same as a tensor on the device, 'latent' ->
        {'latents': (B, H/8, W/8, C)}.
        """
        embeds = dict(prompt_embeds) if prompt_embeds is not None \
            else self.encode_prompt(prompt)
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
        split = self.rows is not None and self.rows.splits(bs)
        if split:
            latents = self.rows.take(latents)
            embeds = {k: self.rows.take(v) for k, v in embeds.items()}
        latents = self.diffusion.forward_test(
            latents, test_cfg_override=override, **embeds)
        if self.vae is None or output_type == 'latent':
            return dict(latents=self.rows.gather(latents) if split
                        else latents)
        images = (self.vae.decode(latents) / 2 + 0.5).clamp(0.0, 1.0)
        if split:
            images = self.rows.gather(images)
        if output_type == 'pt':
            return dict(images=images)
        return dict(images=images.cpu().numpy())


class ArcQwenImagePipeline(ArcFluxPipeline):
    """Qwen-Image-family ArcFlow pipeline: the same sampling; Qwen has no
    guidance embeds, and its prompt embeds carry the text mask
    ``encoder_hidden_states_mask`` through to the transformer."""

    family = 'qwen'

    @classmethod
    def from_pretrained(cls, model_dir: str, transformer_cls=None, **kwargs):
        """``ArcFluxPipeline.from_pretrained`` with the ArcQwen transformer
        unless ``transformer_cls`` says otherwise (JAX, line 467)."""
        from ..models import ArcQwenImageTransformer2DModel
        return super().from_pretrained(
            model_dir,
            transformer_cls=transformer_cls or ArcQwenImageTransformer2DModel,
            **kwargs)


# the scheduler_config.json fields the pipeline takes, under their names
SCHEDULER_FIELDS = ('shift', 'use_dynamic_shifting', 'base_shift',
                    'max_shift', 'base_image_seq_len', 'max_image_seq_len')


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _init_fields(cls) -> set:
    """The named constructor arguments of ``cls`` and its bases."""
    fields = set()
    for klass in cls.__mro__:
        init = klass.__dict__.get('__init__')
        if init is not None:
            fields.update(
                name for name, p in inspect.signature(init).parameters.items()
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                and name != 'self')
    return fields


def merge_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``model``'s parameters, cast to their dtypes.
    The LoRA pair of a layer that has a weight but no LoRA is fused into
    that weight (W += (a b)^T, alpha = rank); any other key the model lacks
    raises. Keys the state lacks keep their values."""
    from .convert import fuse_lora
    own = model.state_dict()
    state = dict(state)
    for key in [k for k in state if k.endswith('.lora_a') and k not in own]:
        base = key[:-len('.lora_a')]
        b = state.pop(base + '.lora_b', None)
        a = state.pop(key)
        if b is None or base + '.weight' not in own:
            raise ValueError(f'LoRA leaves of {base} have no layer to go to')
        weight = state.get(base + '.weight', own[base + '.weight'])
        state[base + '.weight'] = fuse_lora(
            {'w.weight': weight, 'w.lora_a': a.to(weight.device),
             'w.lora_b': b.to(weight.device)})['w.weight']
    unexpected = sorted(set(state) - set(own))
    if unexpected:
        raise ValueError(f'{len(unexpected)} keys the model has no place '
                         f'for, e.g. {unexpected[:5]}')
    model.load_state_dict(state, strict=False)
