"""Port parity: ``data/image_prompts.py:ImagePrompt`` in both modes, item by
item, ``data/samplers.py`` (the bucketized sampler and loader) batch by
batch, against the JAX package on the same files and seeds; and how
``train_model`` picks its loader and its EMA, as JAX does.

Cache mode reads zstd pickle records (``zstandard`` is installed here; the
port imports it only to read a record). Every comparison is exact: both
packages run the same numpy.
"""

import gzip
import json
import pickle

import numpy as np
import pytest
import torch

from arcflow_tpu.data import BucketizedBatchSampler as JSampler
from arcflow_tpu.data import ImagePrompt as JImagePrompt
from arcflow_tpu.data import build_bucketized_loader as j_loader
from arcflow_tpu.runner.ema import EmaConfig as JEmaConfig
from arcflow_tpu.runner.ema import ema_momentum as j_ema_momentum
from arcflow_tpu_torch import DATASETS
from arcflow_tpu_torch.data import (BucketizedBatchSampler, ImagePrompt,
                                    build_bucketized_loader)
from arcflow_tpu_torch.runner.runner import to_device

torch.set_num_threads(1)


def write_cache(tmp_path, n=8, seq=6, dim=16):
    """Cache records of every kind the reader takes: nested embeds with
    CHW torch latents, a latents scale, only a latent size, and the legacy
    flat keys with a mask; rows in two buckets."""
    import zstandard as zstd
    cache = tmp_path / 'cache'
    cache.mkdir(exist_ok=True)
    g = torch.Generator().manual_seed(0)
    names = []
    for i in range(n):
        seq_i = seq + (i % 3) * 3          # 6, 9, 12 tokens
        if i % 4 == 3:
            rec = dict(prompt=f'legacy {i}',
                       prompt_embeds=torch.randn(seq_i, dim, generator=g),
                       prompt_embeds_mask=torch.ones(seq_i, dtype=torch.long),
                       pooled_prompt_embeds=torch.randn(8, generator=g))
        else:
            rec = dict(prompt=f'a photo number {i}', prompt_embed_kwargs=dict(
                encoder_hidden_states=torch.randn(seq_i, dim, generator=g),
                pooled_projections=torch.randn(8, generator=g)))
        if i % 4 == 1:
            rec['latent_size'] = (4, 6, 4)
        else:
            rec['latents'] = torch.randn(4, 8, 8, generator=g)
        if i % 4 == 2:
            rec['latents_scale'] = 0.5
        name = f'rec{i:04d}'
        with open(cache / f'{name}.zst', 'wb') as f:
            with zstd.ZstdCompressor().stream_writer(f) as z:
                pickle.dump(rec, z)
        names.append(name)
    dl = tmp_path / 'datalist.jsonl.gz'
    with gzip.open(dl, 'wt') as f:
        for i, nm in enumerate(names):
            f.write(json.dumps({'name': nm, 'size_idx': i % 2}) + '\n')
    return str(cache), str(dl)


def write_prompts(tmp_path, n=7):
    """A prompts jsonl: rows with size_idx and height / width, a bare
    name, and one row without size columns."""
    path = tmp_path / 'prompts.jsonl'
    with open(path, 'w') as f:
        for i in range(n):
            row = {'prompt': f'prompt {i}', 'size_idx': i % 2,
                   'height': 64 + 32 * (i % 2), 'width': 64}
            if i == 3:
                row = {'name': 'named prompt 3'}
            f.write(json.dumps(row) + '\n')
        f.write('"a bare string row"\n')
    return str(path)


def write_negative(tmp_path, kind):
    rng = np.random.default_rng(3)
    embeds = dict(encoder_hidden_states=rng.standard_normal(
        (10, 16)).astype(np.float32),
        encoder_hidden_states_mask=np.ones(10, np.int64))
    if kind == 'npz':
        path = str(tmp_path / 'neg.npz')
        np.savez(path, **embeds)
    else:
        path = str(tmp_path / 'neg.pth')
        torch.save({k: torch.from_numpy(v) for k, v in embeds.items()}, path)
    return path


def assert_same(got, want, where=''):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f'{where}.{k}')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, \
            (where, type(got), getattr(got, 'dtype', None), want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want and type(got) is type(want), (where, got, want)


CACHE_CASES = [
    dict(pad_seq_len=10),
    dict(pad_seq_len=8, test_mode=True),
    dict(start_ind=-5, end_ind=-1, repeat=2),
    dict(ignore_cached_latents=True, start_ind=2),
    dict(negative='npz', pad_seq_len=12),
    dict(negative='pth'),
]


@pytest.mark.parametrize('case', CACHE_CASES,
                         ids=lambda c: '-'.join(f'{k}={v}'
                                                for k, v in c.items()))
def test_cache_mode_items_match_jax(tmp_path, case):
    cache, dl = write_cache(tmp_path)
    case = dict(case)
    neg = case.pop('negative', None)
    if neg:
        case['negative_prompt_embeds_path'] = write_negative(tmp_path, neg)
    kw = dict(cache_dir=cache, datalist_path=dl, latent_size=(8, 8, 4),
              **case)
    got, want = ImagePrompt(**kw), JImagePrompt(**kw)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.bucket_ids, want.bucket_ids)
    for i in range(len(want)):
        assert_same(got[i], want[i], f'item {i}')


@pytest.mark.parametrize('case', [
    dict(), dict(test_mode=True, negative_prompt='blurry'),
    dict(start_ind=1, end_ind=-2, repeat=3)],
    ids=['plain', 'test_mode', 'sliced'])
def test_prompt_mode_items_match_jax(tmp_path, case):
    kw = dict(prompts_path=write_prompts(tmp_path), latent_size=(8, 8, 4),
              **case)
    got, want = ImagePrompt(**kw), JImagePrompt(**kw)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.bucket_ids, want.bucket_ids)
    for i in range(len(want)):
        assert_same(got[i], want[i], f'item {i}')
    # a prompts list too
    lst = dict(prompts=['a cat', 'a dog'], latent_size=(8, 8, 4))
    assert_same(ImagePrompt(**lst)[1], JImagePrompt(**lst)[1])


def test_registered_and_refuses_what_jax_refuses():
    assert DATASETS.get('ImagePrompt') is ImagePrompt
    with pytest.raises(ValueError):
        ImagePrompt()
    with pytest.raises(ValueError):
        ImagePrompt(cache_dir='somewhere')


@pytest.mark.parametrize('bucket_ids, bs, replicas, seed, shuffle', [
    ([0] * 10 + [1] * 13 + [2] * 7, 2, 2, 0, True),
    ([0] * 16 + [1] * 16, 4, 2, 1, True),
    ([1, 0, 1, 0, 2], 4, 1, 5, True),
    ([0] * 5 + [3] * 6, 2, 1, 2, False)])
def test_bucketized_sampler_draws_jax_batches(bucket_ids, bs, replicas,
                                              seed, shuffle):
    for rank in range(replicas):
        args = (bucket_ids, bs, replicas, rank, seed, shuffle)
        got, want = BucketizedBatchSampler(*args), JSampler(*args)
        assert len(got) == len(want)
        for epoch in range(3):
            for a, b in zip(got.epoch_batches(epoch),
                            want.epoch_batches(epoch), strict=True):
                np.testing.assert_array_equal(a, b)
        for start in (0, 3):
            it_g, it_w = got.iter_batches(start), want.iter_batches(start)
            for _ in range(2 * len(want) + 1):
                np.testing.assert_array_equal(next(it_g), next(it_w))


def test_bucketized_loader_collates_jax_batches(tmp_path):
    kw = dict(prompts_path=write_prompts(tmp_path), latent_size=(8, 8, 4),
              negative_prompt='blurry')
    got = build_bucketized_loader(ImagePrompt(**kw), 2, seed=3, start_iter=1)
    want = j_loader(JImagePrompt(**kw), 2, seed=3, start_iter=1)
    try:
        for _ in range(5):
            b_got, b_want = next(got), next(want)
            assert_same(b_got, b_want)
            assert b_got['prompt_kwargs']['prompt'].dtype.kind == 'U'
    finally:
        got.close()
        want.close()


def test_string_batches_reach_the_model_unbroken():
    """A collated batch's prompt strings stay host numpy; its arrays move
    to the device."""
    batch = dict(ids=np.arange(2), name=np.array(['a', 'b']),
                 prompt_kwargs=dict(prompt=np.array(['a cat', 'a dog'])),
                 latents=np.zeros((2, 4, 4, 4), np.float32), other=[None])
    out = to_device(batch, 'cpu')
    assert isinstance(out['ids'], torch.Tensor)
    assert isinstance(out['latents'], torch.Tensor)
    np.testing.assert_array_equal(out['prompt_kwargs']['prompt'],
                                  ['a cat', 'a dog'])
    assert list(out['name']) == ['a', 'b'] and out['other'] == [None]


def test_ema_default_is_jaxs_fixed_momentum():
    from arcflow_tpu.apis.train import ema_config_from_cfg as j_ema_cfg
    from arcflow_tpu_torch.apis import ema_config_from_cfg
    from arcflow_tpu_torch.config import Config
    from arcflow_tpu_torch.runner.ema import ema_momentum
    cfg = Config(dict(custom_hooks=[]))
    got = ema_config_from_cfg(cfg)
    want = j_ema_cfg(cfg)
    assert isinstance(want, JEmaConfig)
    for it in (0, 5, 1000):
        # JAX holds the momentum in fp32, as the EMA tensors the port
        # multiplies by it
        assert np.float32(ema_momentum(got, it)) == np.float32(
            j_ema_momentum(want, np.int32(it))) == np.float32(0.999)
