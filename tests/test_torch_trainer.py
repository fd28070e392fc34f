"""arcflow_tpu_torch's runner, hooks and the config-built slice, against the
JAX package where it has the same function.

The hooks run in small ``IterBasedRunner`` loops with a stub step;
``QuartileLossLoggerHook`` is fed one log stream next to the JAX hook and
must log the same quartile EMAs (1e-12 relative: the same numpy
arithmetic). The slice as a whole: each checkerboard config, built through
the port's ``MODELS`` with hidden (32, 32), takes the JAX model's init
(carried over with ``jax_params_to_torch``, ``strict=True``) and must give
the JAX loss on the loader's first batch, with the JAX draws replayed as in
``test_torch_train.py``: 1e-5 relative for the flow losses, 1e-4 for the
2-NFE distillation (its rollouts carry the sums' rounding further, as in
``test_torch_toy.py``).
"""

import contextlib
import gc
import itertools
import json
import logging
import os
import signal
import sys
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.apis.train import build_model_from_cfg as j_build_model
from arcflow_tpu.config import Config as JConfig
from arcflow_tpu.data import build_dataloader as j_build_dataloader
from arcflow_tpu.data import build_dataset as j_build_dataset
from arcflow_tpu.runner.hooks import QuartileLossLoggerHook as JQuartile
from arcflow_tpu_torch import Config
from arcflow_tpu_torch.apis import build_model_from_cfg
from arcflow_tpu_torch.data import build_dataloader, build_dataset
from arcflow_tpu_torch.pipelines import jax_params_to_torch
from arcflow_tpu_torch.runner import (CheckpointHook, CheckpointManager,
                                      EvalHook, Hook, IterBasedRunner,
                                      IterTimerHook, JsonLoggerHook,
                                      ProfilerHook, QuartileLossLoggerHook,
                                      TextLoggerHook, TrainState, build_hooks)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ListHandler(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def _logger(name):
    logger = logging.getLogger(name)
    logger.propagate = False
    handler = ListHandler()
    logger.handlers = [handler]
    logger.setLevel(logging.INFO)
    return logger, handler


class StubState:
    step = 0


def stub_runner(tmp_path, hooks, total=6, step_fn=None, **kw):
    logger, handler = _logger(f'runner-{id(hooks)}')
    runner = IterBasedRunner(
        model=None, state=StubState(),
        train_step_fn=step_fn or (lambda s, b: (s, {'loss': torch.tensor(
            float(b['x'].sum()))})),
        data_iter=itertools.repeat({'x': np.ones((2,), np.float32)}),
        total_iters=total, work_dir=str(tmp_path), hooks=hooks,
        logger=logger, device='cpu', **kw)
    return runner, handler


# ---- hooks ----------------------------------------------------------------------

def test_build_hooks_passes_kwargs_and_warns():
    logger, handler = _logger('build-hooks')
    hooks = build_hooks(dict(interval=7, hooks=[
        dict(type='TextLoggerHook', by_epoch=False),
        dict(type='JsonLoggerHook', interval=3, ignore_last=True),
        dict(type='TensorboardLoggerHook'),
        dict(type='NoSuchLoggerHook'),
        dict(type='IterTimerHook', sync=False)]),
        extra_hooks=[Hook()], logger=logger)
    assert [type(h).__name__ for h in hooks] == [
        'TextLoggerHook', 'JsonLoggerHook', 'TensorboardLoggerHook',
        'IterTimerHook', 'Hook']
    assert hooks[0].interval == 7 and hooks[1].interval == 3
    assert hooks[2].interval == 7 and hooks[3].sync is False
    msgs = '\n'.join(handler.records)
    assert 'TensorboardLoggerHook' not in msgs
    assert "unknown hook type 'NoSuchLoggerHook' skipped" in msgs
    assert "JsonLoggerHook: unsupported config keys ['ignore_last']" in msgs


def test_runner_tracks_iteration_on_host_and_moves_batches(tmp_path):
    reads = []

    class CountingStep:
        def __int__(self):
            reads.append(1)
            return 7

    class State:
        step = CountingStep()

    seen = []

    def step_fn(s, b):
        seen.append(b['x'])
        return s, {'loss': 0.0}

    logger, _ = _logger('host-iter')
    runner = IterBasedRunner(
        model=None, state=State(), train_step_fn=step_fn,
        data_iter=itertools.repeat({'x': np.zeros((3,), np.float32)}),
        total_iters=30, work_dir=str(tmp_path), logger=logger, device='cpu')
    runner.run()
    assert runner.iter == 30 and len(reads) == 1 and len(seen) == 23
    assert all(isinstance(x, torch.Tensor) for x in seen)


def test_iter_timer_hook_logs_sections(tmp_path):
    runner, _ = stub_runner(tmp_path, [IterTimerHook(interval=2, sync=True)],
                            total=4)
    syncs = []
    runner._sync = lambda: syncs.append(1)
    runner.run()
    for k in ('time_data', 'time_step', 'time_iter'):
        assert runner.log_buffer[k] >= 0.0
    assert len(syncs) == 4
    assert not runner.timers['data'].enabled and not runner.sync_each_iter


def test_text_and_json_loggers(tmp_path):
    runner, handler = stub_runner(
        tmp_path, [TextLoggerHook(interval=3), JsonLoggerHook(interval=3)])
    runner.run()
    lines = [m for m in handler.records if m.startswith('iter [')]
    assert len(lines) == 2 and 'loss: 2' in lines[0]
    recs = [json.loads(x) for x in open(tmp_path / 'metrics.jsonl')]
    assert recs == [{'iter': 3, 'loss': 2.0}, {'iter': 6, 'loss': 2.0}]


def test_quartile_hook_matches_jax_on_one_log_stream():
    rng = np.random.default_rng(0)
    port, ref = QuartileLossLoggerHook(total_timesteps=1000, momentum=0.2), \
        JQuartile(total_timesteps=1000, momentum=0.2)

    class R:
        log_buffer = {}

    for i in range(25):
        n = 8 + i % 5
        logs = dict(per_sample_loss=rng.random(n).astype(np.float32),
                    timesteps=(rng.random(n) * 1000).astype(np.float32))
        if i % 2:
            logs['per_sample_var'] = rng.random(n).astype(np.float32)
        rp, rj = R(), R()
        rp.log_buffer = {k: torch.from_numpy(v) for k, v in logs.items()}
        rj.log_buffer = dict(logs)
        port.after_train_iter(rp)
        ref.after_train_iter(rj)
        q = {k: v for k, v in rj.log_buffer.items() if 'quartile' in k}
        assert q and q.keys() == {k for k in rp.log_buffer
                                  if 'quartile' in k}
        for k in q:
            np.testing.assert_allclose(rp.log_buffer[k], q[k], rtol=1e-12)
    np.testing.assert_allclose(port.var_q, ref.var_q, rtol=1e-12)
    np.testing.assert_array_equal(port.count_q, ref.count_q)


def test_runner_gc_interval_paces_collections(tmp_path, monkeypatch):
    seen, collects = [], []
    real_collect = gc.collect
    monkeypatch.setattr(gc, 'collect',
                        lambda *a: collects.append(1) or real_collect(*a))

    def step_fn(s, b):
        seen.append(gc.isenabled())
        return s, {'loss': 0.0}

    assert gc.isenabled()
    runner, _ = stub_runner(tmp_path, [], total=6, step_fn=step_fn,
                            gc_interval=2)
    runner.run()
    assert not any(seen), 'GC must be off inside the loop'
    assert gc.isenabled(), 'GC must be back on after the loop'
    assert len(collects) == 1 + 3


def test_profiler_hook_writes_a_trace(tmp_path):
    def step_fn(s, b):
        return s, {'loss': float((torch.ones(16, 16) @ torch.ones(16, 16))
                                 .sum())}
    hook = ProfilerHook(start_iter=2, num_iters=3,
                        out_dir=str(tmp_path / 'prof'))
    runner, _ = stub_runner(tmp_path, [hook], total=8, step_fn=step_fn)
    runner.run()
    trace = json.load(open(hook.trace_path))
    names = {e.get('name', '') for e in trace['traceEvents']}
    assert any('mm' in n for n in names), sorted(names)[:20]


def test_sigterm_finishes_the_iteration_and_force_saves(tmp_path):
    """A hook raises SIGTERM after iteration 2 of 5: the runner ends that
    iteration, CheckpointHook.after_run saves it, the handlers are put
    back."""
    class Raiser(Hook):
        def after_train_iter(self, runner):
            if runner.iter == 2:
                # only into the runner's handler: the default would end
                # the test process
                assert signal.getsignal(signal.SIGTERM) is not before
                signal.raise_signal(signal.SIGTERM)

    class Saver:
        saved = []

        def save(self, state, force=False):
            if force:
                self.saved.append(runner.iter)

        def wait(self):
            pass

    before = signal.getsignal(signal.SIGTERM)
    runner, handler = stub_runner(tmp_path, [Raiser(),
                                             CheckpointHook(Saver())],
                                  total=5)
    runner.run()
    assert runner.iter == 2 and runner.preempted
    assert Saver.saved == [2]
    assert signal.getsignal(signal.SIGTERM) is before
    assert any('preempted at iter 2' in m for m in handler.records)


def test_eval_hook_writes_samples(tmp_path):
    cfg = Config.fromfile(os.path.join(REPO,
                                       'configs/toy/checkerboard_flow.py'))
    cfg.merge_from_dict({'model.diffusion.denoising.hidden': (8,),
                         'test_cfg.num_timesteps': 4})
    model = build_model_from_cfg(cfg, device='cpu')
    trainable, frozen = model.init_params()
    state = TrainState.create(torch.Generator(), trainable, frozen, {},
                              ema_keys=model.ema_keys)
    runner, _ = stub_runner(tmp_path, [EvalHook(interval=2, num_samples=10)],
                            total=2, step_fn=lambda s, b: (s, {}))
    runner.model, runner.state = model, state
    runner.run()
    samples = np.load(tmp_path / 'eval' / 'iter_2.npz')['samples']
    assert samples.shape == (10, 2)
    assert runner.log_buffer['eval_sample_std'] == pytest.approx(
        float(samples.std()))

    # the image branch: a grid of the samples, their CLIP score
    from arcflow_tpu_torch.utils.metrics import clip_score
    clip = write_tiny_clip(str(tmp_path / 'clip'))
    imgs = torch.rand((3, 12, 10, 3), generator=torch.Generator()
                      .manual_seed(0))
    prompts = ['a photo of a cat', 'the quick brown fox', 'a dog']

    class ImageModel:
        def val_step(self, batch, generator, ema=None, **kw):
            return dict(num_samples=3, pred_imgs=imgs)
    hook = EvalHook(interval=1, batch=dict(prompt=prompts),
                    metrics=('latent_fd', 'clip_score'), clip_path=clip)
    runner, _ = stub_runner(tmp_path, [hook], total=1,
                            step_fn=lambda s, b: (s, {}))
    runner.model = ImageModel()
    runner.state.ema = None
    runner.run()
    from PIL import Image
    grid = np.asarray(Image.open(tmp_path / 'eval' / 'iter_1.png'))
    assert grid.shape == (24, 20, 3)                 # 2 x 2 cells
    want = np.clip(imgs[0].numpy() * 255 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(grid[:12, :10], want)
    assert (grid[12:, 10:] == 0).all()
    score = runner.log_buffer['eval_clip_score']
    assert np.isfinite(score)
    assert score == clip_score(imgs.numpy(), prompts, clip_path=clip)
    # without the metric, or without prompts, no score
    for kw in (dict(metrics=()), dict(batch={})):
        hook = EvalHook(**dict(dict(interval=1, batch=dict(prompt=prompts),
                                    metrics=('clip_score',),
                                    clip_path=clip), **kw))
        runner, _ = stub_runner(tmp_path, [hook], total=1,
                                step_fn=lambda s, b: (s, {}))
        runner.model, runner.state.ema = ImageModel(), None
        runner.run()
        assert 'eval_clip_score' not in runner.log_buffer


def write_tiny_clip(d):
    """A tiny CLIP (text and vision towers, 32 x 32 images) with its
    tokenizer and image processor: a folder ``CLIPProcessor`` and
    ``CLIPModel`` load with ``local_files_only``."""
    import transformers as tf

    from test_torch_qwen_text import write_tokenizer
    cfg = tf.CLIPConfig(
        text_config=dict(vocab_size=240, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=77),
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=32, patch_size=8), projection_dim=16)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tf.CLIPModel(cfg).save_pretrained(d)
    write_tokenizer(d)
    os.remove(os.path.join(d, 'tokenizer.json'))    # CLIP's own BPE
    with open(os.path.join(d, 'tokenizer_config.json'), 'w') as fh:
        json.dump(dict(tokenizer_class='CLIPTokenizer',
                       bos_token='<|startoftext|>',
                       eos_token='<|endoftext|>', unk_token='<unk>',
                       pad_token='<|endoftext|>', model_max_length=77), fh)
    tf.CLIPImageProcessor(size={'shortest_edge': 32},
                          crop_size={'height': 32, 'width': 32}
                          ).save_pretrained(d)
    return d


def test_eval_hook_draws_on_the_runners_device(tmp_path):
    """The evaluation's generator lies on the runner's device, also for a
    model without a ``device`` attribute (it was drawn on the CPU)."""
    made = []
    real = torch.Generator

    def generator(device='cpu'):
        made.append(torch.device(device))
        return real()

    class NoDevice:
        def val_step(self, batch, generator, ema=None, **kw):
            return dict(pred_latents=torch.zeros(4, 2, 2, 1))
    hook = EvalHook(interval=1)
    runner, _ = stub_runner(tmp_path, [hook], total=1,
                            step_fn=lambda s, b: (s, {}))
    runner.model, runner.state.ema = NoDevice(), None
    runner.device, runner._iter = torch.device('cuda', 1), 1
    with mock.patch.object(torch, 'Generator', generator):
        hook.after_train_iter(runner)
    assert made == [torch.device('cuda', 1)]


def test_tensorboard_and_wandb_hooks(tmp_path, monkeypatch):
    """TensorBoard events with the scalars (read back), and the wandb
    hook's jsonl fallback without wandb, as in JAX; with a stand-in wandb
    module, its run gets the scalars."""
    from arcflow_tpu_torch.runner import (TensorboardLoggerHook,
                                          WandbLoggerHook)
    tb = TensorboardLoggerHook(interval=2, log_dir=str(tmp_path / 'tb'))
    monkeypatch.setitem(sys.modules, 'wandb', None)
    wb = WandbLoggerHook(interval=2)
    runner, handler = stub_runner(tmp_path, [tb, wb], total=4)
    runner.run()
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(tmp_path / 'tb'))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars('loss')] == \
        [(2, 2.0), (4, 2.0)]
    recs = [json.loads(x) for x in open(tmp_path / 'metrics.jsonl')]
    assert recs == [{'iter': 2, 'loss': 2.0}, {'iter': 4, 'loss': 2.0}]
    assert any('wandb is not installed' in m for m in handler.records)

    logged, inits = [], []

    class Run:
        def log(self, scalars, step):
            logged.append((step, scalars))

        def finish(self):
            logged.append('finished')
    monkeypatch.setitem(sys.modules, 'wandb', types.SimpleNamespace(
        init=lambda **kw: inits.append(kw) or Run()))
    runner, _ = stub_runner(tmp_path, [WandbLoggerHook(
        interval=2, init_kwargs=dict(project='p'))], total=4)
    runner.run()
    assert inits == [dict(dir=str(tmp_path), project='p')]
    assert logged == [(2, {'loss': 2.0}), (4, {'loss': 2.0}), 'finished']


# ---- the slice: config-built models against JAX --------------------------------

@contextlib.contextmanager
def recording(draws):
    real = dict(uniform=jax.random.uniform, normal=jax.random.normal)

    def make(kind):
        def fn(*args, **kwargs):
            out = real[kind](*args, **kwargs)
            if not isinstance(out, jax.core.Tracer):
                draws.append((kind, np.asarray(out)))
            return out
        return fn
    with mock.patch.object(jax.random, 'uniform', make('uniform')), \
            mock.patch.object(jax.random, 'normal', make('normal')):
        yield


@contextlib.contextmanager
def replaying(draws):
    it = iter(draws)

    def make(kind):
        def fn(*size, generator=None, device=None, dtype=None, **kwargs):
            if len(size) == 1 and not isinstance(size[0], int):
                size = tuple(size[0])
            got, x = next(it)
            assert (got, x.shape) == (kind, tuple(size))
            return torch.from_numpy(np.array(x, np.float32)).to(device)
        return fn
    with mock.patch.object(torch, 'rand', make('uniform')), \
            mock.patch.object(torch, 'randn', make('normal')):
        yield
    assert next(it, None) is None, 'not every JAX draw was used'


def _jitter(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        return x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype)
    return jax.tree.map(leaf, jax.device_get(tree))


@pytest.mark.parametrize('path, rtol', [
    ('configs/toy/checkerboard_flow.py', 1e-5),
    ('configs/toy/checkerboard_arcflow_2nfe.py', 1e-4),
    ('configs/gmflow/checkerboard_gmflow.py', 1e-5)])
def test_config_built_loss_matches_jax(path, rtol):
    opts = {'model.diffusion.denoising.hidden': (32, 32),
            'data.train_dataloader.samples_per_gpu': 64}
    if 'arcflow' in path:
        opts.update({'model.teacher.denoising.hidden': (32, 32),
                     'model.teacher_ckpt': None})
    cfg, jcfg = Config.fromfile(os.path.join(REPO, path)), \
        JConfig.fromfile(os.path.join(REPO, path))
    cfg.merge_from_dict(dict(opts))
    jcfg.merge_from_dict(dict(opts))
    assert cfg.to_dict() == jcfg.to_dict()

    jm = j_build_model(jcfg)
    trainable, frozen = jm.init_params(jax.random.PRNGKey(0))
    trainable, frozen = _jitter(trainable, 1), _jitter(frozen, 2)
    tm = build_model_from_cfg(cfg, device='cpu')
    tm.diffusion.denoising.load_state_dict(
        jax_params_to_torch(trainable['diffusion']), strict=True)
    if 'teacher' in frozen:
        tm.teacher.denoising.load_state_dict(
            jax_params_to_torch(frozen['teacher']), strict=True)
    n = cfg.data.train_dataloader.samples_per_gpu
    batch = next(build_dataloader(build_dataset(cfg.data.train), n))
    j_batch = next(j_build_dataloader(j_build_dataset(jcfg.data.train), n))
    np.testing.assert_array_equal(batch['x'], j_batch['x'])

    draws = []
    with recording(draws):
        loss_j, _ = jm.loss(jax.tree.map(jnp.asarray, trainable),
                            jax.tree.map(jnp.asarray, frozen),
                            jax.random.PRNGKey(3),
                            dict(x=jnp.asarray(j_batch['x'])),
                            running_status=dict(iteration=120))
    with replaying(draws):
        loss, logs = tm.loss(dict(x=torch.from_numpy(batch['x'])),
                             torch.Generator(),
                             running_status=dict(iteration=120))
    assert torch.isfinite(loss)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=rtol)


def test_checkpoint_hook_saves_on_the_interval(tmp_path):
    mgr = CheckpointManager(str(tmp_path / 'c'), interval=2)

    class State:
        step = 0
        trainable, ema, frozen, optimizers = {}, None, {}, {}
        generator = torch.Generator()

    def step_fn(s, b):
        s.step += 1
        return s, {}
    runner, _ = stub_runner(tmp_path, [CheckpointHook(mgr)], total=5,
                            step_fn=step_fn)
    runner.state = State()
    runner.run()
    assert sorted(os.listdir(tmp_path / 'c')) == ['2', '4', '5']
