"""The shipped evaluation (``configs/{flux,qwen}/_data_test.py``): its
``EvalHook`` entry gives no batch, so ``apis/train.py:train_model`` builds
one from ``data.test``, the first ``num_samples`` items of that
``ImagePrompt`` set: their prompts, their test noise and their cached
embeds where the cache can be read (zstandard and the records present),
else the prompts alone for the model's text encoder. The JAX package
passes ``dict(num_samples=n)`` there and its ``val_step`` raises at the
first evaluation: a divergence the port does not copy.

The test set is written here: zstd-compressed pickle records under
``data_root/cache_dir`` and a gzipped jsonl datalist, at the shipped
config's keys (``data_root``, ``cache_dir``, ``cache_datalist_path``,
``prompt_dataset_kwargs``). The FLUX config is cut to 1 + 1 blocks of
2 x 16 on the CPU for one iteration with the evaluation after it.
"""

import contextlib
import gzip
import importlib
import json
import os
import pickle
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from arcflow_tpu_torch import Config
from arcflow_tpu_torch.apis import train as t_train
from arcflow_tpu_torch.data import _fastloader as fastloader
from arcflow_tpu_torch.runner import EvalHook, GradClipConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUX = os.path.join(REPO, 'configs/flux/arcflux_2nfe_k16.py')
FLUX_TEST = os.path.join(REPO, 'configs/flux/_data_test.py')
NET = {'num_layers': 1, 'num_single_layers': 1, 'attention_head_dim': 16,
       'num_attention_heads': 2, 'joint_attention_dim': 32,
       'pooled_projection_dim': 16, 'axes_dims_rope': (4, 6, 6),
       'in_channels': 16}
LATENT = (8, 8, 4)
N_RECORDS = 5
N_SAMPLES = 3


def write_test_set(root, cache=True):
    """``N_RECORDS`` records: prompt, (6, 32) text embeds and (16,) pooled
    ones; the zstd files only with ``cache``."""
    os.makedirs(os.path.join(root, 'preproc_flux'), exist_ok=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(N_RECORDS):
        raw = dict(prompt=f'prompt number {i}', latent_size=LATENT,
                   prompt_embed_kwargs=dict(
                       encoder_hidden_states=rng.standard_normal(
                           (6, 32)).astype(np.float32),
                       pooled_projections=rng.standard_normal(
                           16).astype(np.float32)))
        records.append(raw)
        if cache:
            import zstandard
            with open(os.path.join(root, 'preproc_flux', f'r{i}.zst'),
                      'wb') as fh:
                fh.write(zstandard.ZstdCompressor().compress(
                    pickle.dumps(raw)))
    datalist = os.path.join(root, 'preproc_flux.jsonl.gz')
    with gzip.open(datalist, 'wt', encoding='utf-8') as fh:
        for i, raw in enumerate(records):
            fh.write(json.dumps(dict(name=f'r{i}', prompt=raw['prompt']))
                     + '\n')
    return records, datalist


def shipped_test_set(root, datalist):
    """``configs/flux/_data_test.py``'s ``data.test`` at this root."""
    test = dict(Config.fromfile(FLUX_TEST).data.test)
    test.update(data_root=root, cache_datalist_path=datalist,
                latent_size=LATENT)
    return test


def flux_cfg(tmp, test, num_samples=N_SAMPLES):
    """The shipped FLUX config with the shipped evaluation entry
    (``_data_test.py``'s, every 1 iteration instead of 1000), cut to the
    tiny width, its training data the test set's records."""
    cfg = Config.fromfile(FLUX)
    opts = {f'model.diffusion.denoising.{k}': v for k, v in NET.items()}
    opts.update({f'model.teacher.denoising.{k}': v for k, v in NET.items()})
    opts.update({'model.diffusion.denoising.lora_rank': 4,
                 'model.text_embed_dim': 32, 'model.pooled_dim': 16,
                 'model.latent_shape': LATENT,
                 'parallel.mesh': dict(data=1, fsdp=-1),
                 'data.train.cache_dir': test['data_root'] + '/preproc_flux',
                 'data.train.datalist_path': test['cache_datalist_path'],
                 'data.train.latent_size': LATENT,
                 'data.train.pad_seq_len': None,
                 'data.train.end_ind': None,
                 'data.train_dataloader.samples_per_gpu': 1,
                 'checkpoint_config.out_dir': os.path.join(tmp, 'ckpt')})
    cfg.merge_from_dict(opts)
    shipped = Config.fromfile(FLUX_TEST)
    cfg.data['test'] = test
    cfg['evaluation'] = [dict(e, interval=1, num_samples=num_samples)
                         for e in shipped.evaluation]
    return cfg


def test_shipped_evaluation_gets_data_test_prompts_and_embeds(tmp_path):
    """One iteration of the shipped FLUX config with the shipped
    evaluation: the hook's batch holds the first ``num_samples`` records'
    prompts, embeds and test noise, and the evaluation writes its
    latents."""
    records, datalist = write_test_set(str(tmp_path / 'hpsv2'))
    cfg = flux_cfg(str(tmp_path), shipped_test_set(str(tmp_path / 'hpsv2'),
                                                   datalist))
    batches = []
    real = EvalHook.after_train_iter

    def spy(self, runner):
        batches.append(self.batch)
        return real(self, runner)
    with mock.patch.object(EvalHook, 'after_train_iter', spy):
        state, _ = t_train.train_model(cfg, str(tmp_path / 'work'),
                                       device='cpu', max_iters=1)
    assert state.step == 1 and len(batches) == 1
    batch = batches[0]
    assert batch['prompt'] == [r['prompt'] for r in records[:N_SAMPLES]]
    for key in ('encoder_hidden_states', 'pooled_projections'):
        np.testing.assert_array_equal(
            batch['prompt_embed_kwargs'][key].numpy(),
            np.stack([r['prompt_embed_kwargs'][key]
                      for r in records[:N_SAMPLES]]))
    np.testing.assert_array_equal(
        batch['noise'].numpy(),
        np.stack([np.random.default_rng(i).standard_normal(LATENT)
                  for i in range(N_SAMPLES)]).astype(np.float32))
    out = np.load(tmp_path / 'work' / 'eval' / 'iter_1.npz')['samples']
    assert out.shape == (N_SAMPLES, *LATENT) and np.isfinite(out).all()


def test_unreadable_cache_gives_the_prompts_alone(tmp_path):
    """No record files (as on a machine without the cache or without
    ``zstandard``): the datalist's prompts, for the text encoder."""
    records, datalist = write_test_set(str(tmp_path), cache=False)
    batch = t_train.eval_batch_from_test(
        shipped_test_set(str(tmp_path), datalist), N_SAMPLES, 'cpu')
    prompts = [r['prompt'] for r in records[:N_SAMPLES]]
    assert batch['prompt'] == prompts
    assert batch['prompt_kwargs'] == dict(prompt=prompts)
    assert 'prompt_embed_kwargs' not in batch
    assert tuple(batch['noise'].shape) == (N_SAMPLES, *LATENT)


@pytest.mark.parametrize('missing', ['records', 'zstandard'])
def test_unreadable_cache_without_a_text_encoder_raises_before_training(
        tmp_path, missing):
    """The shipped FLUX config builds no text encoder: where the cache
    cannot be read (its records missing, or no ``zstandard`` to read
    them), ``train_model`` says so while it builds the hooks, before the
    first iteration, not at the first evaluation."""
    root = str(tmp_path / 'hpsv2')
    _, datalist = write_test_set(root, cache=missing != 'records')
    cfg = flux_cfg(str(tmp_path), shipped_test_set(root, datalist))
    real = importlib.util.find_spec
    no_zstd = mock.patch.object(
        t_train.importlib.util, 'find_spec',
        lambda name, *a: None if name == 'zstandard' else real(name, *a))
    # nor the native loader, which reads the records without zstandard
    no_native = mock.patch.object(fastloader, 'get_fastloader',
                                  lambda: None)
    why = 'r0.zst is missing' if missing == 'records' \
        else 'zstandard is not installed and the native loader'
    with (no_zstd if missing == 'zstandard' else contextlib.nullcontext()), \
            (no_native if missing == 'zstandard'
             else contextlib.nullcontext()), \
            mock.patch.object(t_train, 'IterBasedRunner',
                              side_effect=AssertionError('runner built')), \
            pytest.raises(ValueError, match=f'preproc_flux .*{why}.* '
                          f'or a text_encoder'):
        t_train.train_model(cfg, str(tmp_path / 'work'), device='cpu',
                            max_iters=1)


def test_jax_raises_at_the_evaluation_the_port_feeds_from_data_test():
    """The divergence: JAX's ``EvalHook`` hands ``val_step``
    ``dict(num_samples=16)`` (``arcflow_tpu/runner/hooks.py:338-339``),
    which it cannot embed."""
    import jax
    tt = importlib.import_module('test_torch_train')
    tmt = importlib.import_module('test_torch_mesh_train')
    jm = tt.jax_model(tmt.arcflux_cfg())
    trainable, frozen = jax.jit(jm.init_params)(jax.random.PRNGKey(1))
    state = SimpleNamespace(
        frozen=frozen,
        params_for_eval=lambda key, prefer_ema: trainable[key])
    shipped = Config.fromfile(FLUX_TEST).evaluation[0]
    assert 'batch' not in shipped
    with pytest.raises(ValueError, match='batch needs prompt_embed_kwargs'):
        jm.val_step(state, jax.random.PRNGKey(0),
                    dict(num_samples=shipped['num_samples']))


def test_flux_train_cfg_skips_no_step_for_its_norm():
    """``configs/flux/_mesh_train.py:23-27`` defines ``train_cfg_base``
    with ``diffusion_grad_clip_skip_ratio=20.0``, but no config merges it:
    the FLUX config's ``train_cfg`` clips at 50 from iteration 100 and
    skips only non-finite steps (skip ratio 0), in both packages."""
    cfg = Config.fromfile(FLUX)
    assert cfg.train_cfg_base['diffusion_grad_clip_skip_ratio'] == 20.0
    clip = GradClipConfig.from_train_cfg(dict(cfg.train_cfg), 'diffusion')
    assert (clip.max_norm, clip.begin_iter, clip.skip_ratio) == (50.0, 100,
                                                                 0.0)
