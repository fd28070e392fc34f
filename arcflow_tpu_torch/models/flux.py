"""FLUX MM-DiT trunk, the teacher with its u head and the ArcFlux student
with its mixture heads.

Counterpart of ``arcflow_tpu/models/flux.py``: 19 dual-stream joint blocks
and 38 single-stream blocks (held in ``nn.ModuleList``s, not scanned
stacks), 3-axis RoPE, AdaLN-zero modulation, guidance embeds (FLUX.1-dev
has them, as every FLUX config of the JAX package), patchify p=2, the
teacher's ``proj_out`` and the three ArcFlow heads, which run in fp32.
Latents are channel last (B, H, W, C) and packed in (p, p, c) feature
order, as in the JAX package.

Training: with ``checkpointing`` each block keeps only its inputs and is run
again in the backward (``torch.utils.checkpoint``, the JAX ``nn.remat``),
and the LoRA dropout of block ``i`` draws from a generator seeded from
``(dropout_seed, i)`` (JAX ``jax.random.fold_in(key, i)``). The seed is an
input of the checkpointed function, so the recompute draws the same masks.

Sequence parallelism (serving): with a ``parallel.SequenceParallel`` state
(``sequence_parallel``, set by ``parallel.set_sequence_parallel``) each rank
keeps its shard of the image tokens and its shard of the text tokens, with
RoPE from the matching slices of the position ids, as the JAX trunk shards
img and txt separately (``arcflow_tpu/models/flux.py:327-330``). The blocks
concatenate [txt_r, img_r] locally, a permutation of the global sequence that
non-causal attention does not see, and the image tokens are gathered before
the heads, so every rank returns the whole output. A stream whose length
``sp`` does not divide gets zero tokens at its end (``parallel/mesh.py:
stream_padding``): they are masked as keys in every attention (the same
key-padding mask a Qwen text mask takes) and their rows are dropped before
the heads, so the output is the unsharded one. Streams ``sp`` divides are
not padded and run unmasked, as before. ControlNet residuals,
fill inputs, MoE and pipeline parallelism wait for their slices.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import (SequenceParallel, pad_tokens, stream_padding,
                             token_validity)
from .layers import (AdaLayerNormContinuous, AdaLayerNormZero,
                     AdaLayerNormZeroSingle, FeedForward, JointAttention,
                     LoRADense, SingleStreamAttention, layer_norm_no_affine,
                     rope_frequencies, timestep_sinusoidal)


# the student's trainable surface (reference freeze_exclude,
# configs/flux/arcflux_2nfe_k16.py:20-26; JAX flux.py:45-46)
ARCFLUX_ADAPTER_KEYS = ('proj_out_means', 'proj_out_logweights',
                        'proj_out_loggamma', 'norm_out', 'lora')


def dropout_generator(seed: Optional[int], index: int, device
                      ) -> Optional[torch.Generator]:
    """The generator of block ``index``'s LoRA dropout for a forward with
    ``seed`` (None: no dropout): a function of both, so a recompute of the
    block draws what its first run drew."""
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B1 + index + 1) % 2 ** 63)
    return g


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, dim: int, lora_rank: int = 0,
                 lora_dropout: float = 0.0, device=None, dtype=None):
        super().__init__()
        kw = dict(lora_rank=lora_rank, lora_dropout=lora_dropout,
                  device=device, dtype=dtype)
        self.linear1 = LoRADense(in_dim, dim, **kw)
        self.linear2 = LoRADense(dim, dim, **kw)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear2(F.silu(self.linear1(x, generator)), generator)


class TimeTextEmbed(nn.Module):
    """Timestep and guidance sinusoidal embeds + pooled-text MLP."""

    def __init__(self, dim: int, pooled_dim: int, lora_rank: int = 0,
                 lora_dropout: float = 0.0, device=None, dtype=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, dtype=dtype)
        self.timestep_embedder = MLPEmbedder(256, dim, lora_rank=lora_rank,
                                             lora_dropout=lora_dropout, **kw)
        self.guidance_embedder = MLPEmbedder(256, dim, **kw)
        self.text_embedder = MLPEmbedder(pooled_dim, dim, **kw)

    def forward(self, t: torch.Tensor, pooled: torch.Tensor,
                guidance: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype or pooled.dtype
        temb = self.timestep_embedder(timestep_sinusoidal(t, 256).to(dt),
                                      generator)
        temb = temb + self.guidance_embedder(
            timestep_sinusoidal(guidance, 256).to(dt))
        return temb + self.text_embedder(pooled.to(dt))


class FluxJointBlock(nn.Module):
    """Dual-stream block: AdaLN-zero per stream, joint attention (with an
    optional key-padding mask (B, 1, 1, S_kv)), gated MLP."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 lora_rank: int = 0, lora_dropout: float = 0.0, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.img_norm1 = AdaLayerNormZero(dim, **kw)
        self.txt_norm1 = AdaLayerNormZero(dim, **kw)
        self.attn = JointAttention(dim, num_heads, head_dim, **kw)
        lora = dict(lora_rank=lora_rank, lora_dropout=lora_dropout)
        self.ff_img = FeedForward(dim, **lora, **kw)
        self.ff_txt = FeedForward(dim, **lora, **kw)

    def forward(self, img, txt, rope, temb, mask=None, generator=None):
        h_img, gate_i, shift_mlp_i, scale_mlp_i, gate_mlp_i = \
            self.img_norm1(img, temb)
        h_txt, gate_t, shift_mlp_t, scale_mlp_t, gate_mlp_t = \
            self.txt_norm1(txt, temb)
        attn_img, attn_txt = self.attn(h_img, h_txt, rope, mask=mask)
        img = img + gate_i * attn_img
        txt = txt + gate_t * attn_txt
        h_img = layer_norm_no_affine(img) * (1 + scale_mlp_i) + shift_mlp_i
        h_txt = layer_norm_no_affine(txt) * (1 + scale_mlp_t) + shift_mlp_t
        img = img + gate_mlp_i * self.ff_img(h_img, generator)
        txt = txt + gate_mlp_t * self.ff_txt(h_txt, generator)
        return img, txt


class FluxSingleBlock(nn.Module):
    """Single-stream block: parallel attention + MLP, fused output proj."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 lora_rank: int = 0, lora_dropout: float = 0.0, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        lora = dict(lora_rank=lora_rank, lora_dropout=lora_dropout, **kw)
        mlp_dim = 4 * dim
        self.norm = AdaLayerNormZeroSingle(dim, **kw)
        self.attn = SingleStreamAttention(dim, num_heads, head_dim, **kw)
        self.proj_mlp = LoRADense(dim, mlp_dim, **lora)
        self.proj_out = LoRADense(num_heads * head_dim + mlp_dim, dim, **lora)

    def forward(self, x, rope, temb, mask=None, generator=None):
        h, gate = self.norm(x, temb)
        attn_out = self.attn(h, rope, mask=mask)
        mlp_h = F.gelu(self.proj_mlp(h, generator), approximate='tanh')
        fused = torch.cat([attn_out, mlp_h], dim=-1)
        return x + gate * self.proj_out(fused, generator)


def make_img_ids(h_tokens: int, w_tokens: int, device=None) -> torch.Tensor:
    """(h*w, 3) latent position ids: [0, row, col]."""
    row = torch.arange(h_tokens, device=device)[:, None].expand(
        h_tokens, w_tokens)
    col = torch.arange(w_tokens, device=device)[None].expand(
        h_tokens, w_tokens)
    return torch.stack([torch.zeros_like(row), row, col], dim=-1).reshape(-1, 3)


def patchify(latents: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, p*p*C), channel-last."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(tokens: torch.Tensor, h: int, w: int, p: int) -> torch.Tensor:
    """(B, N, p*p*C) -> (B, H, W, C)."""
    b, n, pc = tokens.shape
    c = pc // (p * p)
    x = tokens.reshape(b, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class FluxBackbone(nn.Module):
    """Shared trunk: embedders + joint blocks + single blocks."""

    patch_size = 2

    def __init__(self, in_channels: int = 64, num_layers: int = 19,
                 num_single_layers: int = 38, attention_head_dim: int = 128,
                 num_attention_heads: int = 24, joint_attention_dim: int = 4096,
                 pooled_projection_dim: int = 768,
                 axes_dims_rope: Sequence[int] = (16, 56, 56),
                 lora_rank: int = 0, lora_dropout: float = 0.0,
                 checkpointing: bool = True, device=None, dtype=None):
        super().__init__()
        self.in_channels = in_channels
        self.axes_dims_rope = tuple(axes_dims_rope)
        self.lora_dropout = lora_dropout
        self.checkpointing = checkpointing
        self.sequence_parallel = None
        inner = num_attention_heads * attention_head_dim
        self.inner_dim = inner
        kw = dict(device=device, dtype=dtype)
        lora = dict(lora_rank=lora_rank, lora_dropout=lora_dropout)
        self.x_embedder = LoRADense(in_channels, inner, **kw)
        self.context_embedder = LoRADense(joint_attention_dim, inner, **kw)
        self.time_text_embed = TimeTextEmbed(
            inner, pooled_projection_dim, **lora, **kw)
        self.joint_blocks = nn.ModuleList([
            FluxJointBlock(inner, num_attention_heads, attention_head_dim,
                           **lora, **kw)
            for _ in range(num_layers)])
        self.single_blocks = nn.ModuleList([
            FluxSingleBlock(inner, num_attention_heads, attention_head_dim,
                            **lora, **kw)
            for _ in range(num_single_layers)])

    def _block(self, block: nn.Module, index: int,
               dropout_seed: Optional[int], *args):
        """Run ``block(*args)`` with its dropout generator, under activation
        checkpointing when ``checkpointing`` is on and autograd records."""
        def run(seed, *a):
            return block(*a, generator=dropout_generator(seed, index,
                                                         a[0].device))
        if self.checkpointing and torch.is_grad_enabled():
            return checkpoint(run, dropout_seed, *args, use_reentrant=False)
        return run(dropout_seed, *args)

    def trunk(self, packed: torch.Tensor, t: torch.Tensor,
              encoder_hidden_states: torch.Tensor,
              pooled_projections: torch.Tensor, img_ids: torch.Tensor,
              txt_ids: torch.Tensor, guidance: torch.Tensor,
              dropout_seed: Optional[int] = None):
        """packed (B, N_img, in_channels) -> (hidden (B, N_img, D), temb).
        ``dropout_seed`` turns the LoRA dropout on (training)."""
        n_blocks = len(self.joint_blocks) + len(self.single_blocks)
        sp = self.sequence_parallel
        n_img = packed.shape[1]
        pad_t, pad_i = stream_padding(sp, encoder_hidden_states.shape[1],
                                      n_img)
        valid = None                         # (txt, img) key validity
        if pad_t or pad_i:
            valid = [token_validity(encoder_hidden_states, pad_t),
                     token_validity(packed, pad_i)]
            encoder_hidden_states = pad_tokens(encoder_hidden_states, pad_t)
            txt_ids = pad_tokens(txt_ids, pad_t, dim=0)
            packed = pad_tokens(packed, pad_i)
            img_ids = pad_tokens(img_ids, pad_i, dim=0)
        # a LocalRing keeps every shard in this process: nothing to cut
        if isinstance(sp, SequenceParallel):
            packed, img_ids = sp.shard(packed), sp.shard(img_ids, dim=0)
            encoder_hidden_states = sp.shard(encoder_hidden_states)
            txt_ids = sp.shard(txt_ids, dim=0)
            if valid is not None:
                valid = [sp.shard(v) for v in valid]
        mask = None if valid is None else \
            torch.cat(valid, dim=1)[:, None, None, :]
        img = self.x_embedder(packed)
        txt = self.context_embedder(encoder_hidden_states)
        temb = self.time_text_embed(
            t.float() * 1000.0, pooled_projections, guidance.float() * 1000.0,
            generator=dropout_generator(dropout_seed, n_blocks, packed.device))
        rope = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0),
                                self.axes_dims_rope)
        for i, block in enumerate(self.joint_blocks):
            img, txt = self._block(block, i, dropout_seed, img, txt, rope,
                                   temb, mask)
        hidden = torch.cat([txt, img], dim=1)
        for i, block in enumerate(self.single_blocks, len(self.joint_blocks)):
            hidden = self._block(block, i, dropout_seed, hidden, rope, temb,
                                 mask)
        img = hidden[:, txt.shape[1]:]
        if isinstance(sp, SequenceParallel):
            img = sp.gather(img)
        return img[:, :n_img], temb

    def _prepare_tokens(self, hidden_states, encoder_hidden_states):
        """patchify + position ids."""
        b, h, w, c = hidden_states.shape
        p = self.patch_size
        dev = hidden_states.device
        img_ids = make_img_ids(h // p, w // p, device=dev)
        txt_ids = torch.zeros((encoder_hidden_states.shape[1], 3),
                              dtype=img_ids.dtype, device=dev)
        return patchify(hidden_states, p), img_ids, txt_ids


class ArcFlowHeads:
    """``norm_out`` and the three ArcFlow mixture heads, shared by the
    ArcFlux and ArcQwen students (a mixin of their ``nn.Module``).

    Output dict (channel-last pixel-latent space):
      means      (B, K, H, W, C)
      logweights (B, K, H, W, 1)   log-softmax over K, per patch cell
      loggammas  (B, K-1, H, W, 1)
    """

    def _init_heads(self, num_gaussians: int, device=None, dtype=None):
        self.num_gaussians = k = num_gaussians
        p = self.patch_size
        c = self.in_channels // (p * p)
        inner = self.inner_dim
        self.norm_out = AdaLayerNormContinuous(inner, device=device,
                                               dtype=dtype)
        # heads in fp32, zero kernels; biases: 0.1*randn per (component,
        # pixel channel) shared over the p*p cells for the means, zero for
        # the logweights, log-spaced rates in [0.2, 4] for the loggammas
        f32 = dict(device=device, dtype=torch.float32)
        self.proj_out_means = LoRADense(inner, k * p * p * c, **f32)
        self.proj_out_logweights = LoRADense(inner, k * p * p, **f32)
        self.proj_out_loggamma = LoRADense(inner, (k - 1) * p * p, **f32)
        with torch.no_grad():
            for head in (self.proj_out_means, self.proj_out_logweights,
                         self.proj_out_loggamma):
                head.weight.zero_()
            noise = 0.1 * torch.randn(k, 1, c, **f32)
            self.proj_out_means.bias.copy_(noise.expand(k, p * p, c).reshape(-1))
            self.proj_out_logweights.bias.zero_()
            target = torch.logspace(math.log10(0.2), math.log10(4.0), k - 1,
                                    **f32)
            self.proj_out_loggamma.bias.copy_(
                torch.log(target)[:, None].expand(k - 1, p * p).reshape(-1))

    def _heads(self, hidden: torch.Tensor, temb: torch.Tensor, b: int,
               h: int, w: int) -> dict:
        """Trunk tokens (B, N, D) -> the mixture dict, heads in fp32."""
        p = self.patch_size
        k = self.num_gaussians
        c = self.in_channels // (p * p)
        hidden = self.norm_out(hidden, temb).float()
        n = hidden.shape[1]

        means = self.proj_out_means(hidden).reshape(b, n, k, p * p, c)
        logweights = torch.log_softmax(
            self.proj_out_logweights(hidden).reshape(b, n, k, p * p, 1), dim=2)
        loggammas = self.proj_out_loggamma(hidden).reshape(
            b, n, k - 1, p * p, 1)

        def to_pixel(x, kk, ch):
            # (B, N, K, p*p, ch) -> (B, K, H, W, ch)
            x = x.permute(0, 2, 1, 3, 4).reshape(b * kk, n, p * p * ch)
            return unpatchify(x, h, w, p).reshape(b, kk, h, w, ch)

        return dict(means=to_pixel(means, k, c),
                    logweights=to_pixel(logweights, k, 1),
                    loggammas=to_pixel(loggammas, k - 1, 1))


class ArcFluxTransformer2DModel(ArcFlowHeads, FluxBackbone):
    """FLUX trunk + the three ArcFlow mixture heads (see ``ArcFlowHeads``
    for the output dict). It always has guidance embeds."""

    guidance_embeds = True

    def __init__(self, num_gaussians: int = 16, device=None, dtype=None,
                 **kwargs):
        super().__init__(device=device, dtype=dtype, **kwargs)
        self._init_heads(num_gaussians, device=device, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor, t: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor,
                guidance: torch.Tensor,
                dropout_seed: Optional[int] = None) -> dict:
        b, h, w, _ = hidden_states.shape
        packed, img_ids, txt_ids = self._prepare_tokens(
            hidden_states, encoder_hidden_states)
        hidden, temb = self.trunk(packed, t, encoder_hidden_states,
                                  pooled_projections, img_ids, txt_ids,
                                  guidance, dropout_seed)
        return self._heads(hidden, temb, b, h, w)


class FluxTransformer2DModel(FluxBackbone):
    """The teacher: the FLUX trunk + ``norm_out`` and the fp32 ``proj_out``
    u head (JAX ``flux.py:428-459``); returns u (B, H, W, C) in fp32."""

    guidance_embeds = True

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
                pooled_projections: torch.Tensor,
                guidance: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        b, h, w, _ = hidden_states.shape
        packed, img_ids, txt_ids = self._prepare_tokens(
            hidden_states, encoder_hidden_states)
        hidden, temb = self.trunk(packed, t, encoder_hidden_states,
                                  pooled_projections, img_ids, txt_ids,
                                  guidance, dropout_seed)
        out = self.proj_out(self.norm_out(hidden, temb).float())
        return unpatchify(out, h, w, self.patch_size)
