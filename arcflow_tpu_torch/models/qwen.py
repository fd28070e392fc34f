"""Qwen-Image MM-DiT trunk, the teacher with its u head and the ArcQwen
student with its mixture heads.

Counterpart of ``arcflow_tpu/models/qwen.py`` (``QwenJointBlock``,
``make_qwen_img_ids``, ``QwenBackbone``, ``QwenImageTransformer2DModel``,
``ArcQwenImageTransformer2DModel``):
60 dual-stream joint blocks (no single-stream stage) in an
``nn.ModuleList`` named ``transformer_blocks``, RMSNorm on the raw text
stream, a timestep-only embedder (no pooled text, no guidance embeds),
centred 3-axis RoPE, text truncation at ``max_text_len``, and a text key
mask in every block's joint attention. The heads are ArcFlux's
(``flux.py:ArcFlowHeads``). Under sequence parallelism the trunk shards its
tokens as the FLUX trunk does, and the text mask with the text tokens, so
each rank's key mask is [txt_mask_r, ones(img_r)]; a stream that ``sp``
does not divide is padded with masked tokens, as in the FLUX trunk.
Training, under ``sp`` too: activation checkpointing, the per-block LoRA
dropout generators and their token streams are the FLUX trunk's
(``flux.py:run_block``). ``moe_experts`` > 0 makes both stream MLPs of
every block expert-choice MoE FFNs (JAX ``qwen.py:39-88, 120-165``); with
a pipe state (``pipe``) the 60 blocks run as a pipeline where the pipe
degree divides them (``flux.py:run_stack``), the text mask and the image
validity riding the microbatches.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..parallel.mesh import (SequenceParallel, global_rows, pad_tokens,
                             stream_padding, token_streams, token_validity)
from ..registry import MODULES
from .flux import (ArcFlowHeads, FluxJointBlock, MLPEmbedder, check_fixed,
                   check_moe_sp, dropout_generator, make_img_ids, patchify,
                   run_block, run_stack, unpatchify)
from .layers import (AdaLayerNormContinuous, LoRADense, RMSNorm,
                     rope_frequencies, timestep_sinusoidal)


class QwenJointBlock(FluxJointBlock):
    """Dual-stream block whose joint attention masks padded text keys: the
    key mask over the [txt, img] sequence is [txt_mask, img_valid], where
    ``img_valid`` (every image token when None) marks the image tokens that
    sequence-parallel padding did not add."""

    def forward(self, img, txt, rope, temb,
                txt_mask: Optional[torch.Tensor] = None,
                img_valid: Optional[torch.Tensor] = None, generator=None):
        mask = None
        if txt_mask is not None or img_valid is not None:
            key_mask = torch.cat([token_validity(txt, 0, txt_mask),
                                  token_validity(img, 0, img_valid)], dim=1)
            mask = key_mask[:, None, None, :]          # (B, 1, 1, S_kv)
        return super().forward(img, txt, rope, temb, mask=mask,
                               generator=generator)


def make_qwen_img_ids(h_tokens: int, w_tokens: int, device=None
                      ) -> torch.Tensor:
    """Latent position ids [0, row, col] centred on the latent's middle
    (the reference's scaled rope), so they can be negative."""
    ids = make_img_ids(h_tokens, w_tokens, device=device)
    return ids - torch.tensor([0, h_tokens // 2, w_tokens // 2],
                              dtype=ids.dtype, device=device)


class QwenBackbone(nn.Module):
    """Shared Qwen-Image trunk: embedders + joint blocks."""

    patch_size = 2
    guidance_embeds = False
    family = 'qwen'     # the diffusers key maps (pipelines/convert.py)

    def __init__(self, in_channels: int = 64, num_layers: int = 60,
                 attention_head_dim: int = 128, num_attention_heads: int = 24,
                 joint_attention_dim: int = 3584,
                 axes_dims_rope: Sequence[int] = (16, 56, 56),
                 max_text_len: Optional[int] = None, lora_rank: int = 0,
                 lora_dropout: float = 0.0, moe_experts: int = 0,
                 moe_capacity_factor: float = 1.0, checkpointing: bool = True,
                 patch_size: int = 2, pretrained=None,
                 pretrained_adapter=None, device=None, dtype=None):
        super().__init__()
        # loaded by the training composition or from_pretrained (see
        # flux.py:FluxBackbone)
        check_fixed(patch_size=(patch_size, 2), pretrained=(pretrained, None),
                    pretrained_adapter=(pretrained_adapter, None))
        self.in_channels = self.out_channels = in_channels
        self.axes_dims_rope = tuple(axes_dims_rope)
        self.max_text_len = max_text_len
        self.lora_dropout = lora_dropout
        self.checkpointing = checkpointing
        self.moe_experts = moe_experts
        self.sequence_parallel = None
        self.pipe = None
        self.dtype = dtype if dtype is not None else torch.get_default_dtype()
        inner = num_attention_heads * attention_head_dim
        self.inner_dim = inner
        kw = dict(device=device, dtype=dtype)
        self.img_in = LoRADense(in_channels, inner, **kw)
        self.txt_norm = RMSNorm(joint_attention_dim, **kw)
        self.txt_in = LoRADense(joint_attention_dim, inner, **kw)
        lora = dict(lora_rank=lora_rank, lora_dropout=lora_dropout)
        self.timestep_embedder = MLPEmbedder(256, inner, **lora, **kw)
        self.transformer_blocks = nn.ModuleList([
            QwenJointBlock(inner, num_attention_heads, attention_head_dim,
                           **lora, moe_experts=moe_experts,
                           moe_capacity_factor=moe_capacity_factor, **kw)
            for _ in range(num_layers)])

    def trunk(self, packed: torch.Tensor, t: torch.Tensor,
              encoder_hidden_states: torch.Tensor,
              encoder_hidden_states_mask: Optional[torch.Tensor],
              img_ids: torch.Tensor, dropout_seed: Optional[int] = None):
        """packed (B, N_img, in_channels) -> (hidden (B, N_img, D), temb).
        ``dropout_seed`` turns the LoRA dropout on (training)."""
        dt = self.dtype
        if self.max_text_len is not None and \
                encoder_hidden_states.shape[1] > self.max_text_len:
            encoder_hidden_states = encoder_hidden_states[:, :self.max_text_len]
            if encoder_hidden_states_mask is not None:
                encoder_hidden_states_mask = \
                    encoder_hidden_states_mask[:, :self.max_text_len]
        sp = self.sequence_parallel
        check_moe_sp(self.moe_experts, sp)
        n_img = packed.shape[1]
        pad_t, pad_i = stream_padding(sp, encoder_hidden_states.shape[1],
                                      n_img)
        streams = token_streams(sp, encoder_hidden_states.shape[1], n_img,
                                packed.device)
        img_valid = None                         # see flux.py:FluxBackbone
        if pad_t or pad_i:
            encoder_hidden_states_mask = token_validity(
                encoder_hidden_states, pad_t, encoder_hidden_states_mask)
            img_valid = token_validity(packed, pad_i)
            encoder_hidden_states = pad_tokens(encoder_hidden_states, pad_t)
            packed = pad_tokens(packed, pad_i)
            img_ids = pad_tokens(img_ids, pad_i, dim=0)
        if isinstance(sp, SequenceParallel):
            packed, img_ids = sp.shard(packed), sp.shard(img_ids, dim=0)
            encoder_hidden_states = sp.shard(encoder_hidden_states)
            if encoder_hidden_states_mask is not None:
                encoder_hidden_states_mask = sp.shard(
                    encoder_hidden_states_mask)
            if img_valid is not None:
                img_valid = sp.shard(img_valid)
        img = self.img_in(packed.to(dt))
        txt = self.txt_in(self.txt_norm(encoder_hidden_states.to(dt)))
        n_blocks = len(self.transformer_blocks)
        temb = self.timestep_embedder(
            timestep_sinusoidal(t.float() * 1000.0, 256).to(dt),
            dropout_generator(dropout_seed, n_blocks,
                              global_rows(packed.shape[0]), packed.device))
        txt_ids = torch.zeros((txt.shape[1], 3), dtype=img_ids.dtype,
                              device=img_ids.device)
        rope = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0),
                                self.axes_dims_rope)
        if encoder_hidden_states_mask is not None:
            encoder_hidden_states_mask = encoder_hidden_states_mask.bool()
        def joint(i, block, carry, riders):
            return run_block(block, i, dropout_seed, self.checkpointing,
                             *carry, rope, *riders, streams=streams)

        img, txt = run_stack(self.transformer_blocks, joint, (img, txt),
                             (temb, encoder_hidden_states_mask, img_valid),
                             self.pipe)
        if isinstance(sp, SequenceParallel):
            img = sp.gather(img)
        return img[:, :n_img], temb


    def _tokens(self, hidden_states, t, encoder_hidden_states,
                encoder_hidden_states_mask, dropout_seed):
        """The trunk on a latent (B, H, W, C): (hidden, temb)."""
        _, h, w, _ = hidden_states.shape
        p = self.patch_size
        img_ids = make_qwen_img_ids(h // p, w // p,
                                    device=hidden_states.device)
        return self.trunk(patchify(hidden_states, p), t,
                          encoder_hidden_states, encoder_hidden_states_mask,
                          img_ids, dropout_seed)


@MODULES.register_module()
class ArcQwenImageTransformer2DModel(ArcFlowHeads, QwenBackbone):
    """Qwen trunk + the three ArcFlow mixture heads; the output contract is
    ArcFlux's (``flux.py:ArcFlowHeads``). Qwen-Image has no guidance embeds:
    the training composition passes no ``guidance`` (the JAX module
    swallows it in ``**kwargs``)."""

    def __init__(self, num_gaussians: int = 16, device=None, dtype=None,
                 **kwargs):
        super().__init__(device=device, dtype=dtype, **kwargs)
        self._init_heads(num_gaussians, device=device, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor, t: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                encoder_hidden_states_mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> dict:
        b, h, w, _ = hidden_states.shape
        hidden, temb = self._tokens(hidden_states, t, encoder_hidden_states,
                                    encoder_hidden_states_mask, dropout_seed)
        return self._heads(hidden, temb, b, h, w)


@MODULES.register_module()
class QwenImageTransformer2DModel(QwenBackbone):
    """The teacher: the Qwen trunk + ``norm_out`` and the fp32 ``proj_out``
    u head (JAX ``qwen.py:177-198``); returns u (B, H, W, C) in fp32."""

    def __init__(self, device=None, dtype=None, **kwargs):
        super().__init__(device=device, dtype=dtype, **kwargs)
        self.init_head(device=device, dtype=dtype)

    def init_head(self, device=None, dtype=None):
        """(Re)make ``norm_out`` and ``proj_out``. The training composition
        builds the teacher's trunk without storage (it borrows the
        student's) and only this head on the device."""
        self.norm_out = AdaLayerNormContinuous(self.inner_dim, device=device,
                                               dtype=dtype)
        self.proj_out = LoRADense(self.inner_dim, self.in_channels,
                                  device=device, dtype=torch.float32)

    def forward(self, hidden_states: torch.Tensor, t: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                encoder_hidden_states_mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        _, h, w, _ = hidden_states.shape
        hidden, temb = self._tokens(hidden_states, t, encoder_hidden_states,
                                    encoder_hidden_states_mask, dropout_seed)
        out = self.proj_out(self.norm_out(hidden, temb).float())
        return unpatchify(out, h, w, self.patch_size)
