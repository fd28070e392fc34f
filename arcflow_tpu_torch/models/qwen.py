"""Qwen-Image MM-DiT trunk and the ArcQwen student with its mixture heads.

Counterpart of ``arcflow_tpu/models/qwen.py`` (``QwenJointBlock``,
``make_qwen_img_ids``, ``QwenBackbone``, ``ArcQwenImageTransformer2DModel``):
60 dual-stream joint blocks (no single-stream stage) in an
``nn.ModuleList`` named ``transformer_blocks``, RMSNorm on the raw text
stream, a timestep-only embedder (no pooled text, no guidance embeds),
centred 3-axis RoPE, text truncation at ``max_text_len``, and a text key
mask in every block's joint attention. The heads are ArcFlux's
(``flux.py:ArcFlowHeads``). Under sequence parallelism the trunk shards its
tokens as the FLUX trunk does, and the text mask with the text tokens, so
each rank's key mask is [txt_mask_r, ones(img_r)]; a stream that ``sp``
does not divide is padded with masked tokens, as in the FLUX trunk. The
teacher
``QwenImageTransformer2DModel`` and MoE wait for the training slices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..parallel.mesh import (SequenceParallel, pad_tokens, stream_padding,
                             token_validity)
from ..registry import MODULES
from .flux import (ArcFlowHeads, FluxJointBlock, MLPEmbedder, check_fixed,
                   make_img_ids, patchify)
from .layers import LoRADense, RMSNorm, rope_frequencies, timestep_sinusoidal


class QwenJointBlock(FluxJointBlock):
    """Dual-stream block whose joint attention masks padded text keys: the
    key mask over the [txt, img] sequence is [txt_mask, img_valid], where
    ``img_valid`` (every image token when None) marks the image tokens that
    sequence-parallel padding did not add."""

    def forward(self, img, txt, rope, temb,
                txt_mask: Optional[torch.Tensor] = None,
                img_valid: Optional[torch.Tensor] = None):
        mask = None
        if txt_mask is not None or img_valid is not None:
            key_mask = torch.cat([token_validity(txt, 0, txt_mask),
                                  token_validity(img, 0, img_valid)], dim=1)
            mask = key_mask[:, None, None, :]          # (B, 1, 1, S_kv)
        return super().forward(img, txt, rope, temb, mask=mask)


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
                 patch_size: int = 2, pretrained=None,
                 pretrained_adapter=None, device=None, dtype=None):
        super().__init__()
        check_fixed(patch_size=(patch_size, 2), pretrained=(pretrained, None),
                    pretrained_adapter=(pretrained_adapter, None))
        self.in_channels = in_channels
        self.axes_dims_rope = tuple(axes_dims_rope)
        self.max_text_len = max_text_len
        self.sequence_parallel = None
        self.dtype = dtype if dtype is not None else torch.get_default_dtype()
        inner = num_attention_heads * attention_head_dim
        self.inner_dim = inner
        kw = dict(device=device, dtype=dtype)
        self.img_in = LoRADense(in_channels, inner, **kw)
        self.txt_norm = RMSNorm(joint_attention_dim, **kw)
        self.txt_in = LoRADense(joint_attention_dim, inner, **kw)
        self.timestep_embedder = MLPEmbedder(256, inner, lora_rank=lora_rank,
                                             **kw)
        self.transformer_blocks = nn.ModuleList([
            QwenJointBlock(inner, num_attention_heads, attention_head_dim,
                           lora_rank=lora_rank, **kw)
            for _ in range(num_layers)])

    def trunk(self, packed: torch.Tensor, t: torch.Tensor,
              encoder_hidden_states: torch.Tensor,
              encoder_hidden_states_mask: Optional[torch.Tensor],
              img_ids: torch.Tensor):
        """packed (B, N_img, in_channels) -> (hidden (B, N_img, D), temb)."""
        dt = self.dtype
        if self.max_text_len is not None and \
                encoder_hidden_states.shape[1] > self.max_text_len:
            encoder_hidden_states = encoder_hidden_states[:, :self.max_text_len]
            if encoder_hidden_states_mask is not None:
                encoder_hidden_states_mask = \
                    encoder_hidden_states_mask[:, :self.max_text_len]
        sp = self.sequence_parallel
        n_img = packed.shape[1]
        pad_t, pad_i = stream_padding(sp, encoder_hidden_states.shape[1],
                                      n_img)
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
        temb = self.timestep_embedder(
            timestep_sinusoidal(t.float() * 1000.0, 256).to(dt))
        txt_ids = torch.zeros((txt.shape[1], 3), dtype=img_ids.dtype,
                              device=img_ids.device)
        rope = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0),
                                self.axes_dims_rope)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, rope, temb, encoder_hidden_states_mask,
                             img_valid)
        if isinstance(sp, SequenceParallel):
            img = sp.gather(img)
        return img[:, :n_img], temb


@MODULES.register_module()
class ArcQwenImageTransformer2DModel(ArcFlowHeads, QwenBackbone):
    """Qwen trunk + the three ArcFlow mixture heads; the output contract is
    ArcFlux's (``flux.py:ArcFlowHeads``)."""

    def __init__(self, num_gaussians: int = 16, device=None, dtype=None,
                 **kwargs):
        super().__init__(device=device, dtype=dtype, **kwargs)
        self._init_heads(num_gaussians, device=device, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor, t: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                encoder_hidden_states_mask: Optional[torch.Tensor] = None
                ) -> dict:
        b, h, w, _ = hidden_states.shape
        p = self.patch_size
        img_ids = make_qwen_img_ids(h // p, w // p,
                                    device=hidden_states.device)
        hidden, temb = self.trunk(patchify(hidden_states, p), t,
                                  encoder_hidden_states,
                                  encoder_hidden_states_mask, img_ids)
        return self._heads(hidden, temb, b, h, w)
