"""Prompt encoders: CLIP-L + T5-XXL for FLUX, Qwen2.5-VL for Qwen-Image,
CLIP-L + CLIP-G + T5 for SD3.

Counterpart of ``arcflow_tpu/models/text_encoders.py``: each encoder turns
a batch of prompts into the conditioning its DiT takes
(``encoder_hidden_states`` with ``pooled_projections`` or
``encoder_hidden_states_mask``), padded to a fixed length. The FLUX and SD3
towers are transformers' torch classes (the JAX package runs their Flax
twins); the Qwen tower is the native decoder of ``models/qwen_text.py`` by
default (``backend='native'``, JAX's ``'flax'``), or transformers'
Qwen2.5-VL class (``backend='transformers'``, JAX's ``'torch'``), which
carries a vision tower prompt encoding never runs.

Towers load lazily from local folders on the first call, onto ``device``
('cuda' unless the caller asks for the CPU) in ``dtype``; the outputs lie
on the towers' device. Tokenizers load with ``AutoTokenizer`` and models
with ``dtype=``, which transformers 4.57 and 5.x both take. ``from_modules``
wraps towers that are already built (random towers at published widths
in ``chip_smoke.py``). Remote hub names need a download first: nothing
here fetches.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..registry import MODULES
from .vae import torch_dtype


def _transformers():
    import transformers
    return transformers


def _tokenizer(path: str):
    return _transformers().AutoTokenizer.from_pretrained(path)


def _model(cls_name: str, path: str, device, dtype):
    cls = getattr(_transformers(), cls_name)
    return cls.from_pretrained(path, dtype=dtype).to(device).eval()


def _device(module) -> torch.device:
    return next(module.parameters()).device


def _ids(tokenizer, prompt: Sequence[str], length: int, device):
    enc = tokenizer(list(prompt), padding='max_length', max_length=length,
                    truncation=True, return_tensors='pt')
    return enc['input_ids'].to(device), enc['attention_mask'].to(device)


class _LazyEncoder:
    """Shared lazy loading: ``_load_towers`` runs once, before the first
    encode, unless ``from_modules`` set the towers."""

    _loaded = False

    def _load(self):
        if not self._loaded:
            self._load_towers()
            self._loaded = True

    @classmethod
    def _wrap(cls, **attrs):
        obj = cls.__new__(cls)
        obj.__dict__.update(attrs)
        obj._loaded = True
        return obj


@MODULES.register_module()
class PretrainedFluxTextEncoder(_LazyEncoder):
    """CLIP-L's pooled output at 77 tokens + T5-XXL's sequence at
    ``max_sequence_length`` tokens (JAX ``PretrainedFluxTextEncoder``).
    Tokenizer folders default to the model folders (diffusers pipeline
    folders keep them in sibling ``tokenizer*/`` folders)."""

    def __init__(self, clip_path: str = 'openai/clip-vit-large-patch14',
                 t5_path: str = 'google/t5-v1_1-xxl',
                 max_sequence_length: int = 512, dtype='bfloat16',
                 freeze: bool = True,
                 clip_tokenizer_path: Optional[str] = None,
                 t5_tokenizer_path: Optional[str] = None,
                 device='cuda', **kwargs):
        self.clip_path = clip_path
        self.t5_path = t5_path
        self.clip_tokenizer_path = clip_tokenizer_path or clip_path
        self.t5_tokenizer_path = t5_tokenizer_path or t5_path
        self.max_sequence_length = max_sequence_length
        self.dtype = torch_dtype(dtype)
        self.device = device

    @classmethod
    def from_modules(cls, clip, t5, clip_tokenizer, t5_tokenizer,
                     max_sequence_length: int = 512):
        """An encoder around built towers (``CLIPTextModel``,
        ``T5EncoderModel``) and their tokenizers."""
        return cls._wrap(clip=clip, t5=t5, clip_tokenizer=clip_tokenizer,
                         t5_tokenizer=t5_tokenizer,
                         max_sequence_length=max_sequence_length)

    def _load_towers(self):
        self.clip_tokenizer = _tokenizer(self.clip_tokenizer_path)
        self.clip = _model('CLIPTextModel', self.clip_path, self.device,
                           self.dtype)
        self.t5_tokenizer = _tokenizer(self.t5_tokenizer_path)
        self.t5 = _model('T5EncoderModel', self.t5_path, self.device,
                         self.dtype)

    @torch.inference_mode()
    def __call__(self, prompt: Sequence[str], **kwargs) -> Dict[str, Any]:
        self._load()
        ids, _ = _ids(self.clip_tokenizer, prompt, 77, _device(self.clip))
        pooled = self.clip(input_ids=ids).pooler_output
        ids, _ = _ids(self.t5_tokenizer, prompt, self.max_sequence_length,
                      _device(self.t5))
        seq = self.t5(input_ids=ids).last_hidden_state
        return dict(encoder_hidden_states=seq, pooled_projections=pooled)


@MODULES.register_module()
class PretrainedQwenImageTextEncoder(_LazyEncoder):
    """Qwen2.5-VL-7B prompt encoder (JAX ``PretrainedQwenImageTextEncoder``):
    each prompt in the chat template, tokenized to ``pad_seq_len`` + 34
    tokens, the decoder's last hidden states in fp32 with the template's
    first 34 tokens dropped, and the int32 mask of the rest. 34 is the real
    tokenizer's template length: another tokenizer drops 34 of its own
    tokens, as in JAX."""

    PROMPT_TEMPLATE = (
        '<|im_start|>system\nDescribe the image by detailing the color, '
        'shape, size, texture, quantity, text, spatial relationships of the '
        'objects and background:<|im_end|>\n'
        '<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n')
    PROMPT_TEMPLATE_DROP_IDX = 34
    BACKENDS = ('native', 'transformers')

    def __init__(self, pretrained: str = 'Qwen/Qwen2.5-VL-7B-Instruct',
                 pad_seq_len: Optional[int] = 512, dtype='bfloat16',
                 freeze: bool = True, backend: str = 'native',
                 tokenizer_path: Optional[str] = None, device='cuda',
                 **kwargs):
        if backend not in self.BACKENDS:
            raise ValueError(f'backend {backend!r}: one of {self.BACKENDS}')
        self.pretrained = pretrained
        self.tokenizer_path = tokenizer_path or pretrained
        self.pad_seq_len = pad_seq_len
        self.dtype = torch_dtype(dtype)
        self.backend = backend
        self.device = device

    @classmethod
    def from_modules(cls, model, tokenizer, pad_seq_len: Optional[int] = 512):
        """A native-backend encoder around a built ``Qwen25TextModel`` and
        its tokenizer."""
        return cls._wrap(model=model, tokenizer=tokenizer,
                         pad_seq_len=pad_seq_len, backend='native')

    def _load_towers(self):
        self.tokenizer = _tokenizer(self.tokenizer_path)
        if self.backend == 'native':
            from .qwen_text import load_qwen25_text_params
            self.model = load_qwen25_text_params(
                self.pretrained, device=self.device, dtype=self.dtype)
            return
        # the VL class, what diffusers' QwenImagePipeline loads; the
        # causal-LM auto class for text-only checkpoints
        tf = _transformers()
        errors = []
        for name in ('Qwen2_5_VLForConditionalGeneration',
                     'AutoModelForImageTextToText', 'AutoModelForCausalLM'):
            if not hasattr(tf, name):
                continue
            try:
                self.model = _model(name, self.pretrained, self.device,
                                    self.dtype)
                return
            except (ValueError, OSError, KeyError) as e:
                errors.append((name, e))
        raise RuntimeError(f'could not load {self.pretrained}: {errors}')

    @torch.inference_mode()
    def __call__(self, prompt: Sequence[str], **kwargs) -> Dict[str, Any]:
        self._load()
        texts = [self.PROMPT_TEMPLATE.format(p) for p in prompt]
        drop = self.PROMPT_TEMPLATE_DROP_IDX
        dev = _device(self.model)
        if self.backend == 'native':
            length = self.pad_seq_len + drop \
                if self.pad_seq_len is not None else 1024
            ids, mask = _ids(self.tokenizer, texts, length, dev)
            hidden = self.model(ids, mask)[:, drop:]
            mask = mask[:, drop:]
        else:
            hidden, mask = self._call_transformers(texts, dev)
        return dict(encoder_hidden_states=hidden.float(),
                    encoder_hidden_states_mask=mask.to(torch.int32))

    def _call_transformers(self, texts, dev):
        """JAX ``_call_torch``: pad to the longest prompt, run the VL model,
        then pad or cut to ``pad_seq_len``."""
        enc = self.tokenizer(texts, padding=True, return_tensors='pt')
        enc = {k: v.to(dev) for k, v in enc.items()}
        hidden = self.model(**enc, output_hidden_states=True
                            ).hidden_states[-1]
        drop = self.PROMPT_TEMPLATE_DROP_IDX
        hidden, mask = hidden[:, drop:], enc['attention_mask'][:, drop:]
        if self.pad_seq_len is not None:
            pad = self.pad_seq_len - hidden.shape[1]
            if pad > 0:
                hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
                mask = torch.nn.functional.pad(mask, (0, pad))
            else:
                hidden = hidden[:, :self.pad_seq_len]
                mask = mask[:, :self.pad_seq_len]
        return hidden, mask


@MODULES.register_module()
class PretrainedStableDiffusion3TextEncoder(_LazyEncoder):
    """SD3's three towers (JAX ``PretrainedStableDiffusion3TextEncoder``):
    ``encoder_hidden_states`` = [CLIP-L and CLIP-G penultimate hidden
    states side by side, zero-padded to T5's width ; T5's sequence] along
    the tokens, ``pooled_projections`` = the two CLIP projections side by
    side."""

    def __init__(self, clip_l_path: str = 'openai/clip-vit-large-patch14',
                 clip_g_path: str = 'laion/CLIP-ViT-bigG-14-laion2B-39B-b160k',
                 t5_path: str = 'google/t5-v1_1-xxl',
                 max_sequence_length: int = 256, dtype='bfloat16',
                 device='cuda', **kwargs):
        self.clip_l_path = clip_l_path
        self.clip_g_path = clip_g_path
        self.t5_path = t5_path
        self.max_sequence_length = max_sequence_length
        self.dtype = torch_dtype(dtype)
        self.device = device

    def _load_towers(self):
        def clip(path):
            return (_tokenizer(path),
                    _model('CLIPTextModelWithProjection', path, self.device,
                           self.dtype))
        self.clip_l_tok, self.clip_l = clip(self.clip_l_path)
        self.clip_g_tok, self.clip_g = clip(self.clip_g_path)
        self.t5_tokenizer = _tokenizer(self.t5_path)
        self.t5 = _model('T5EncoderModel', self.t5_path, self.device,
                         self.dtype)

    @staticmethod
    def _clip_embed(tok, model, prompt):
        ids, _ = _ids(tok, prompt, 77, _device(model))
        out = model(input_ids=ids, output_hidden_states=True)
        return out.hidden_states[-2], out.text_embeds

    @torch.inference_mode()
    def __call__(self, prompt: Sequence[str], **kwargs) -> Dict[str, Any]:
        self._load()
        h_l, p_l = self._clip_embed(self.clip_l_tok, self.clip_l, prompt)
        h_g, p_g = self._clip_embed(self.clip_g_tok, self.clip_g, prompt)
        clip_seq = torch.cat([h_l, h_g], dim=-1)
        ids, _ = _ids(self.t5_tokenizer, prompt, self.max_sequence_length,
                      _device(self.t5))
        t5_seq = self.t5(input_ids=ids).last_hidden_state
        clip_seq = torch.nn.functional.pad(
            clip_seq, (0, t5_seq.shape[-1] - clip_seq.shape[-1]))
        return dict(
            encoder_hidden_states=torch.cat([clip_seq.to(t5_seq.device),
                                             t5_seq], dim=1),
            pooled_projections=torch.cat([p_l, p_g], dim=-1))
