"""ImagePrompt dataset: prompts, or cached prompt embeddings, for
text-to-image distillation.

The port's own copy of ``arcflow_tpu/data/image_prompts.py`` (it imports
no JAX): two modes,

  (a) cache mode: a jsonl(.gz) datalist naming zstd-compressed pickle
      records ``{prompt, prompt_embed_kwargs, latents? | latent_size,
      latents_scale?}``; ``zstandard`` is imported when a record is read;
  (b) prompt mode: raw prompts (a list, or a jsonl(.gz) whose rows may carry
      ``size_idx`` and ``height`` / ``width``) that the model's text encoder
      embeds inside the loss.

Plus ``pad_seq_len`` truncation and padding with masks, the legacy flat-key
remap, negative prompt embeds from one ``.npz`` or ``.pth`` file, per-index
test noise (``np.random.default_rng(idx)``), ``start_ind`` / ``end_ind``
slicing (negative from the end), ``repeat`` and resolution bucket ids from
``size_idx``. Items are channel-last numpy, as in JAX; the runner moves
them to the device. ``getitems`` reads a batch of cache records through
the native loader (``_fastloader``: a thread pool that reads and
zstd-decompresses them with libzstd's C library, so the cache reads where
the ``zstandard`` package is absent) and unpickles them here, as JAX's
does; where the loader cannot be built it reads item by item, which needs
``zstandard``.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..registry import DATASETS


def _to_numpy(x):
    """A torch tensor, numpy array or scalar -> numpy (tensors in fp32)."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        return np.asarray(x)
    if hasattr(x, 'detach'):
        return x.detach().to('cpu').float().numpy()
    return np.asarray(x)


def _chw_to_hwc(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, 0, -1) if x.ndim == 3 else x


def load_datalist(path: str) -> List[dict]:
    """A jsonl(.gz) datalist; each line a name or {'name': ..., ...}."""
    opener = gzip.open if path.endswith('.gz') else open
    out = []
    with opener(path, 'rt', encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                rec = line
            if isinstance(rec, str):
                rec = {'name': rec}
            out.append(rec)
    return out


@DATASETS.register_module()
class ImagePrompt:
    def __init__(self,
                 cache_dir: Optional[str] = None,
                 datalist_path: Optional[str] = None,
                 prompts: Optional[Sequence[str]] = None,
                 prompts_path: Optional[str] = None,
                 negative_prompt_embeds_path: Optional[str] = None,
                 negative_prompt: Optional[str] = None,
                 latent_size=(128, 128, 16),
                 pad_seq_len: Optional[int] = None,
                 start_ind: int = 0,
                 end_ind: Optional[int] = None,
                 repeat: int = 1,
                 test_mode: bool = False,
                 ignore_cached_latents: bool = False):
        self.cache_dir = cache_dir
        self.test_mode = test_mode
        self.ignore_cached_latents = ignore_cached_latents
        self.latent_size = tuple(latent_size)
        self.pad_seq_len = pad_seq_len
        self.repeat = repeat

        if cache_dir is not None:
            if datalist_path is None:
                raise ValueError('cache mode needs a datalist')
            self.datalist = load_datalist(datalist_path)
        elif prompts_path is not None:
            self.datalist = load_datalist(prompts_path)
            for r in self.datalist:
                r.setdefault('prompt', r.get('name'))
        elif prompts is not None:
            self.datalist = [{'prompt': p} for p in prompts]
        else:
            raise ValueError('need cache_dir+datalist, prompts, or '
                             'prompts_path')

        n = len(self.datalist)
        if end_ind is None:
            end_ind = n
        # negative indices count from the end
        self.start_ind = start_ind % n if start_ind < 0 else start_ind
        self.end_ind = end_ind % n if end_ind < 0 else min(end_ind, n)

        self.negative_prompt = negative_prompt
        self.negative_prompt_embed_kwargs = None
        if negative_prompt_embeds_path is not None:
            self.negative_prompt_embed_kwargs = self._load_embed_file(
                negative_prompt_embeds_path)
        # resolution buckets from the datalist's size_idx
        self.bucket_ids = np.asarray(
            [r.get('size_idx', 0) for r in self.datalist[
                self.start_ind:self.end_ind]], np.int64)

    @staticmethod
    def _load_embed_file(path: str) -> Dict[str, np.ndarray]:
        if path.endswith('.npz'):
            return {k: np.asarray(v) for k, v in np.load(path).items()}
        import torch
        data = torch.load(path, map_location='cpu', weights_only=False)
        return {k: _to_numpy(v) for k, v in data.items()}

    def __len__(self):
        return self.repeat * (self.end_ind - self.start_ind)

    def _map_idx(self, idx: int) -> int:
        return self.start_ind + (idx // self.repeat) % \
            (self.end_ind - self.start_ind)

    def parse_prompt_embeds(self, raw: dict) -> Dict[str, np.ndarray]:
        """A record's embed kwargs (legacy flat keys remapped), padded or
        cut to ``pad_seq_len`` with the mask to match."""
        pek = raw.get('prompt_embed_kwargs')
        if pek is None:
            pek = {}
            remap = {'prompt_embeds': 'encoder_hidden_states',
                     'pooled_prompt_embeds': 'pooled_projections',
                     'prompt_embeds_mask': 'encoder_hidden_states_mask'}
            for old, new in remap.items():
                if old in raw:
                    pek[new] = raw[old]
        pek = {k: _to_numpy(v) for k, v in pek.items()}
        if self.pad_seq_len is not None and 'encoder_hidden_states' in pek:
            seq = pek['encoder_hidden_states']
            s = seq.shape[0]
            if s < self.pad_seq_len:
                pad = self.pad_seq_len - s
                pek['encoder_hidden_states'] = np.pad(seq, ((0, pad), (0, 0)))
                mask = pek.get('encoder_hidden_states_mask',
                               np.ones((s,), np.int64))
                pek['encoder_hidden_states_mask'] = np.pad(mask, (0, pad))
            else:
                pek['encoder_hidden_states'] = seq[:self.pad_seq_len]
                if 'encoder_hidden_states_mask' in pek:
                    pek['encoder_hidden_states_mask'] = \
                        pek['encoder_hidden_states_mask'][:self.pad_seq_len]
        return pek

    def getitems(self, indices) -> list:
        """The items of ``indices``: in cache mode their records read and
        zstd-decompressed together by the native loader, on its threads
        with the GIL released, then unpickled here (JAX ``getitems``); item
        by item where there is no cache or no loader."""
        if self.cache_dir is None:
            return [self[int(i)] for i in indices]
        from ._fastloader import get_fastloader
        fast = get_fastloader()
        if fast is None:
            return [self[int(i)] for i in indices]
        blobs = fast.load_batch([self._record_path(int(i)) for i in indices],
                                num_threads=0, decompress=True)
        return [self._build_item(int(i), pickle.loads(blob))
                for i, blob in zip(indices, blobs)]

    def _record_path(self, idx: int) -> str:
        rec = self.datalist[self._map_idx(idx)]
        return os.path.join(self.cache_dir, f'{rec["name"]}.zst')

    def _noise(self, idx: int, shape) -> np.ndarray:
        return np.random.default_rng(idx).standard_normal(shape).astype(
            np.float32)

    def _negatives(self, data: dict) -> dict:
        if self.negative_prompt_embed_kwargs is not None:
            data['negative_prompt_embed_kwargs'] = \
                self.negative_prompt_embed_kwargs
        if self.negative_prompt is not None:
            data['negative_prompt_kwargs'] = dict(prompt=self.negative_prompt)
        return data

    def _build_item(self, idx: int, raw: dict) -> dict:
        """One sample from a decoded cache record."""
        rec = self.datalist[self._map_idx(idx)]
        data: Dict[str, Any] = dict(
            ids=idx, name=raw.get('prompt', rec['name']),
            prompt_embed_kwargs=self.parse_prompt_embeds(raw))
        if not self.ignore_cached_latents:
            if 'latents' in raw:
                latents = _chw_to_hwc(_to_numpy(raw['latents']))
                if self.test_mode:
                    data['noise'] = self._noise(idx, latents.shape)
                else:
                    scale = raw.get('latents_scale')
                    data['latents'] = latents * scale if scale is not None \
                        else latents
            else:
                size = tuple(raw.get('latent_size', self.latent_size))
                if self.test_mode:
                    data['noise'] = self._noise(idx, size)
                else:
                    data['latents'] = np.zeros(size, np.float32)
        return self._negatives(data)

    def __getitem__(self, idx: int) -> dict:
        rec = self.datalist[self._map_idx(idx)]
        if self.cache_dir is not None:
            import zstandard as zstd
            with open(self._record_path(idx), 'rb') as fh:
                with zstd.ZstdDecompressor().stream_reader(fh) as f:
                    raw = pickle.load(f)
            return self._build_item(idx, raw)
        prompt = rec['prompt']
        data = dict(ids=idx, name=prompt, prompt_kwargs=dict(prompt=prompt))
        size = self._latent_size_for(rec)
        if self.test_mode:
            data['noise'] = self._noise(idx, size)
        else:
            data['latents'] = np.zeros(size, np.float32)
        return self._negatives(data)

    def _latent_size_for(self, rec: dict):
        """Channel-last latent size from a row's height and width (the
        VAE's 8x downsampling), else ``latent_size``."""
        if 'height' in rec and 'width' in rec:
            return (rec['height'] // 8, rec['width'] // 8,
                    self.latent_size[-1])
        return self.latent_size
