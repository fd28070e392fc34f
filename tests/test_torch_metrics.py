"""Port parity: the sample-quality metrics (``utils/metrics.py``) against
the JAX package's (to 1e-10, both fp64 numpy), and ``EvalHook``'s
latent-FD branch, on by default as in JAX (``tests/test_metrics.py``)."""

import logging
import os
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch

from arcflow_tpu.utils import metrics as j_metrics
from arcflow_tpu_torch.runner import EvalHook
from arcflow_tpu_torch.utils import metrics

TOL = 1e-10


@pytest.mark.parametrize('shift,scale', [(0.0, 1.0), (0.5, 1.0), (2.0, 3.0)])
def test_frechet_distances_equal_jax(shift, scale):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 8))
    b = rng.standard_normal((512, 8)) * scale + shift
    got = metrics.frechet_distance(a, b)
    assert abs(got - j_metrics.frechet_distance(a, b)) <= TOL
    lat_a = rng.standard_normal((64, 8, 8, 4)).astype(np.float32)
    lat_b = (rng.standard_normal((64, 8, 8, 4)) * scale + shift).astype(
        np.float32)
    got = metrics.latent_frechet_distance(lat_a, lat_b)
    assert abs(got - j_metrics.latent_frechet_distance(lat_a, lat_b)) <= TOL
    np.testing.assert_array_equal(metrics.latent_stats_features(lat_a),
                                  j_metrics.latent_stats_features(lat_a))


def test_latent_fd_orders_distribution_gaps():
    rng = np.random.default_rng(1)
    ref = rng.standard_normal((256, 8, 8, 4)).astype(np.float32)
    good = rng.standard_normal((256, 8, 8, 4)).astype(np.float32)
    bad = 0.3 * rng.standard_normal((256, 8, 8, 4)).astype(np.float32) + 1.0
    assert metrics.latent_frechet_distance(good, ref) < \
        metrics.latent_frechet_distance(bad, ref)


def test_clip_score_is_none_without_weights():
    """Without CLIP weights on disk ``clip_score`` is None, and it asks
    transformers for local files only (a stub stands in for transformers,
    whose import alone costs seconds)."""
    calls = []

    def absent(path, **kwargs):
        calls.append(kwargs)
        raise OSError(f'{path} is not on disk')
    stub = types.SimpleNamespace(
        CLIPProcessor=types.SimpleNamespace(from_pretrained=absent),
        CLIPModel=types.SimpleNamespace(from_pretrained=absent))
    with mock.patch.dict(sys.modules, transformers=stub):
        assert metrics.clip_score(np.zeros((2, 8, 8, 3), np.float32),
                                  ['a', 'b'], clip_path='no-clip') is None
    assert calls == [dict(local_files_only=True)]


def test_eval_hook_logs_latent_fd_by_default(tmp_path):
    rng = np.random.default_rng(2)
    ref = rng.standard_normal((64, 4, 4, 2)).astype(np.float32)
    samples = rng.standard_normal((64, 4, 4, 2)).astype(np.float32)

    class Model:
        device = 'cpu'

        def val_step(self, batch, generator, ema=None, **kw):
            return dict(pred_latents=torch.from_numpy(samples))

    class Runner:
        iter = 100
        device = torch.device('cpu')
        model = Model()
        state = types.SimpleNamespace(ema=None)
        work_dir = str(tmp_path)
        log_buffer = {}
        logger = logging.getLogger('test')

    hook = EvalHook(interval=100, batch=dict(latents=torch.from_numpy(ref)))
    assert hook.metrics == ('latent_fd',)
    hook.after_train_iter(Runner())
    assert Runner.log_buffer['eval_latent_fd'] == pytest.approx(
        j_metrics.latent_frechet_distance(samples, ref), abs=TOL)
    assert Runner.log_buffer['eval_sample_std'] == pytest.approx(
        float(samples.std()))
    assert os.path.exists(tmp_path / 'eval' / 'iter_100.npz')
    Runner.log_buffer = {}
    EvalHook(interval=100, batch=dict(latents=ref),
             metrics=()).after_train_iter(Runner())
    assert 'eval_latent_fd' not in Runner.log_buffer
    # JAX's config metrics build; on latents the CLIP score has no images
    Runner.log_buffer = {}
    EvalHook(interval=100, batch=dict(latents=ref, prompt=['a']),
             metrics=('latent_fd', 'clip_score'),
             clip_path='no-clip').after_train_iter(Runner())
    assert 'eval_latent_fd' in Runner.log_buffer
    assert 'eval_clip_score' not in Runner.log_buffer


def test_clip_score_asks_for_local_files_only_unlike_jax():
    """JAX's ``clip_score`` calls ``from_pretrained`` without
    ``local_files_only`` (``arcflow_tpu/utils/metrics.py:60-61``), so a
    CLIP missing from the disk is fetched from the hub where there is a
    network; the port's never fetches (ROADMAP queue C)."""
    calls = []

    def absent(path, **kwargs):
        calls.append(kwargs)
        raise OSError(f'{path} is not on disk')
    stub = types.SimpleNamespace(
        CLIPProcessor=types.SimpleNamespace(from_pretrained=absent),
        CLIPModel=types.SimpleNamespace(from_pretrained=absent),
        FlaxCLIPModel=types.SimpleNamespace(from_pretrained=absent))
    imgs = np.zeros((1, 8, 8, 3), np.float32)
    with mock.patch.dict(sys.modules, transformers=stub):
        assert j_metrics.clip_score(imgs, ['a'], clip_path='c') is None
        assert metrics.clip_score(imgs, ['a'], clip_path='c') is None
    assert calls == [{}, dict(local_files_only=True)]
