"""Native Qwen2.5 text decoder for Qwen-Image prompt encoding.

Counterpart of ``arcflow_tpu/models/qwen_text.py`` (``Qwen25TextModel``,
``load_qwen25_text_params``): the decoder of Qwen2.5-VL-7B, the only part
prompt encoding uses (no image enters the template), without the
transformers VL class and its vision tower. On text alone Qwen's mrope
reduces to the half-split rotary of llama (all three position sections
carry the same index). As in JAX: RMSNorm in fp32, q/k/v with bias, GQA by
repeating the key/value heads, attention logits in fp32 with a causal and
key-padding bias of -1e30, softmax and the value product in fp32 (a plain
``torch.matmul``: JAX runs this attention outside any Pallas kernel), the
output after the final norm in fp32.

Parameter names are the HF checkpoint's, so a checkpoint loads by
stripping its decoder prefix (``load_qwen25_text_params``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# the decoder prefixes of the checkpoints transformers has written (the VL
# class moved its language model across versions), JAX qwen_text.py:170-177
DECODER_PREFIXES = ('model.language_model.', 'language_model.model.',
                    'model.')


class RMSNormF32(nn.Module):
    """x / rms(x) * weight in fp32, returning fp32."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.weight


def rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
              ) -> torch.Tensor:
    """Half-split rotary (HF ``rotate_half``) on (B, S, H, D) in fp32, cast
    back to x's dtype; cos, sin (S, D)."""
    x32 = x.float()
    half = x32.shape[-1] // 2
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos[None, :, None] + rotated * sin[None, :, None]
            ).to(x.dtype)


class Qwen25Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, kv_heads: int, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.heads, self.kv_heads = heads, kv_heads
        self.head_dim = hd = hidden // heads
        self.q_proj = nn.Linear(hidden, heads * hd, **kw)
        self.k_proj = nn.Linear(hidden, kv_heads * hd, **kw)
        self.v_proj = nn.Linear(hidden, kv_heads * hd, **kw)
        self.o_proj = nn.Linear(heads * hd, hidden, bias=False, **kw)

    def forward(self, h, cos, sin, bias):
        b, s, _ = h.shape
        hd = self.head_dim
        q = rope_half(self.q_proj(h).view(b, s, self.heads, hd), cos, sin)
        k = rope_half(self.k_proj(h).view(b, s, self.kv_heads, hd), cos, sin)
        v = self.v_proj(h).view(b, s, self.kv_heads, hd)
        rep = self.heads // self.kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(logits + bias, dim=-1)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
        return self.o_proj(out.to(h.dtype))


class Qwen25MLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(hidden, intermediate, **kw)
        self.up_proj = nn.Linear(hidden, intermediate, **kw)
        self.down_proj = nn.Linear(intermediate, hidden, **kw)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class Qwen25DecoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, kv_heads: int,
                 intermediate: int, eps: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNormF32(hidden, eps, device)
        self.self_attn = Qwen25Attention(hidden, heads, kv_heads, **kw)
        self.post_attention_layernorm = RMSNormF32(hidden, eps, device)
        self.mlp = Qwen25MLP(hidden, intermediate, **kw)

    def forward(self, x, cos, sin, bias):
        dt = x.dtype
        x = x + self.self_attn(self.input_layernorm(x).to(dt), cos, sin, bias)
        return x + self.mlp(self.post_attention_layernorm(x).to(dt))


class Qwen25TextModel(nn.Module):
    """Qwen2.5 decoder returning the hidden states after the final norm, in
    fp32: transformers' ``hidden_states[-1]`` of the same checkpoint.
    ``dtype`` is the compute dtype of the embeddings and linears; the norms
    keep fp32 weights."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int,
                 num_heads: int, num_kv_heads: int, intermediate_size: int,
                 rope_theta: float = 1e6, rms_norm_eps: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.rope_theta = rope_theta
        self.embed_tokens = nn.Embedding(vocab_size, hidden_size, **kw)
        self.layers = nn.ModuleList([
            Qwen25DecoderLayer(hidden_size, num_heads, num_kv_heads,
                               intermediate_size, rms_norm_eps, **kw)
            for _ in range(num_layers)])
        self.norm = RMSNormF32(hidden_size, rms_norm_eps, device)

    def rope(self, s: int, device):
        hd = self.embed_tokens.embedding_dim // self.num_heads
        inv = 1.0 / (self.rope_theta ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
        ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] \
            * inv[None]
        return (torch.cat([ang.cos()] * 2, dim=-1),
                torch.cat([ang.sin()] * 2, dim=-1))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, s = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        cos, sin = self.rope(s, dev)
        causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
        keep = causal[None] & (attention_mask[:, None, :] > 0)
        bias = torch.where(keep, 0.0, -1e30)[:, None].to(torch.float32)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, cos, sin, bias)
        return self.norm(x)


def qwen25_text_config(model_dir: str) -> dict:
    """The constructor arguments of ``Qwen25TextModel`` from a Qwen2.5(-VL)
    ``config.json`` (``text_config`` for VL checkpoints)."""
    with open(os.path.join(model_dir, 'config.json')) as f:
        cfg = json.load(f)
    tc = dict(cfg.get('text_config') or cfg)
    return dict(
        vocab_size=tc['vocab_size'], hidden_size=tc['hidden_size'],
        num_layers=tc['num_hidden_layers'],
        num_heads=tc['num_attention_heads'],
        num_kv_heads=tc.get('num_key_value_heads',
                            tc['num_attention_heads']),
        intermediate_size=tc['intermediate_size'],
        rope_theta=float(tc.get('rope_theta', 1e6)),
        rms_norm_eps=float(tc.get('rms_norm_eps', 1e-6)))


def decoder_state(state: dict, model_dir: str = '') -> dict:
    """The decoder's tensors of a Qwen2.5(-VL) checkpoint with their prefix
    stripped; the vision tower and ``lm_head`` are dropped."""
    for prefix in DECODER_PREFIXES:
        if any(k.startswith(prefix + 'embed_tokens') for k in state):
            return {k[len(prefix):]: v for k, v in state.items()
                    if k.startswith(prefix)}
    raise ValueError(f'no Qwen text decoder found in {model_dir}')


def load_qwen25_text_params(model_dir: str, device=None,
                            dtype=torch.bfloat16) -> Qwen25TextModel:
    """A ``Qwen25TextModel`` in eval mode with the decoder weights of an HF
    Qwen2.5(-VL) checkpoint folder, built on ``device`` in ``dtype`` (norm
    weights in fp32), loaded with ``strict=True``."""
    from ..pipelines.convert import load_safetensors_state
    with torch.device('meta'):
        model = Qwen25TextModel(**qwen25_text_config(model_dir), dtype=dtype)
    state = decoder_state(load_safetensors_state(model_dir), model_dir)
    model.load_state_dict(state, strict=True, assign=True)
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            p.data = p.data.to(device=device, dtype=torch.float32 if
                               isinstance(module, RMSNormF32) else dtype)
    return model.eval()
