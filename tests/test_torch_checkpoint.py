"""arcflow_tpu_torch.runner.checkpoint: save/restore round trips, the
downcast policies, pruning, the ``tmp:`` scheme and crash safety.

A small checkerboard flow model (``configs/toy/checkerboard_flow.py`` at
hidden (32, 32)) takes a few real AdamW + EMA steps on the CPU; its state
is saved, a second state of the same model with other values restores it,
and the two are compared. fp32 checkpoints restore bitwise (and the next
step of both states is bitwise equal); fp16 / bf16 ones restore to the live
values rounded to that dtype, in the live dtype. The JAX package has no
such file format to compare with (it uses Orbax), so the references here
are the live tensors themselves.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from arcflow_tpu_torch import Config
from arcflow_tpu_torch.apis import build_model_from_cfg, ema_config_from_cfg
from arcflow_tpu_torch.runner import (CheckpointManager, TrainState,
                                      build_optimizers, build_train_step,
                                      load_raw_checkpoint)
from arcflow_tpu_torch.runner.checkpoint import resolve_checkpoint_dir

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make(seed=0):
    """(cfg, model, state, train_step) of the reduced checkerboard flow."""
    cfg = Config.fromfile(os.path.join(REPO, 'configs/toy/'
                                       'checkerboard_flow.py'))
    cfg.merge_from_dict({'model.diffusion.denoising.hidden': (32, 32)})
    torch.manual_seed(seed)
    model = build_model_from_cfg(cfg, device='cpu')
    trainable, frozen = model.init_params()
    opts = build_optimizers(dict(cfg.optimizer), trainable)
    state = TrainState.create(torch.Generator().manual_seed(seed), trainable,
                              frozen, opts, ema_keys=model.ema_keys)
    step = build_train_step(model, opts, cfg.train_cfg,
                            ema_config_from_cfg(cfg))
    return cfg, model, state, step


def run(state, step, n, seed=1):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        state, _ = step(state, dict(x=torch.from_numpy(
            rng.standard_normal((32, 2)).astype(np.float32))))
    return state


def flat(state):
    """Every tensor of the state, and the generator state, by name."""
    out = {f'trainable.{n}': t for n, t in
           state.trainable['diffusion'].items()}
    out.update({f'ema.{n}': t for n, t in state.ema['diffusion'].items()})
    for k, tx in state.optimizers.items():
        for i, s in tx.state_dict()['state'].items():
            out.update({f'opt.{k}.{i}.{n}': v for n, v in s.items()})
    out['generator'] = state.generator.get_state()
    return out


def assert_bitwise(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k
    assert a.step == b.step


@pytest.mark.parametrize('async_save', [True, False])
def test_fp32_round_trip_is_bitwise_and_resumes_exactly(tmp_path, async_save):
    _, _, state, step = make()
    state = run(state, step, 3)
    mgr = CheckpointManager(str(tmp_path / 'ckpt'), interval=3,
                            async_save=async_save)
    assert mgr.save(state) and not mgr.save(state, force=True)
    mgr.wait()
    assert mgr.latest_step() == 3 and mgr.last_save['bytes'] > 0
    _, _, other, other_step = make(seed=5)
    other = run(other, other_step, 1, seed=9)
    before = other.opt_states['diffusion']
    CheckpointManager(str(tmp_path / 'ckpt')).restore(other)
    assert_bitwise(other, state)
    # the state's view of the optimizer state is the reloaded one
    assert other.opt_states['diffusion'] is not before
    assert other.opt_states['diffusion'] is \
        other.optimizers['diffusion'].state
    # the next step is the same on both
    assert_bitwise(run(other, other_step, 2, seed=4),
                   run(state, step, 2, seed=4))
    raw = load_raw_checkpoint(str(tmp_path / 'ckpt'))
    assert raw['step'] == 3 and 'frozen' not in raw
    assert set(raw) == {'step', 'trainable', 'ema', 'optimizers',
                        'generator'}


def test_downcast_policies_restore_in_the_live_dtype(tmp_path):
    _, _, state, step = make()
    state = run(state, step, 2)
    mgr = CheckpointManager(str(tmp_path / 'c'), interval=1, ckpt_fp16=True,
                            ckpt_fp16_ema=True, ckpt_bf16_optim=True,
                            async_save=False)
    mgr.save(state)
    raw = load_raw_checkpoint(str(tmp_path / 'c'))
    assert all(t.dtype == torch.float16
               for t in raw['trainable']['diffusion'].values())
    assert all(t.dtype == torch.float16
               for t in raw['ema']['diffusion'].values())
    slots = raw['optimizers']['diffusion']['state']
    assert all(s['exp_avg'].dtype == torch.bfloat16 and
               s['step'].dtype == torch.float32 for s in slots.values())
    _, _, other, _ = make(seed=3)
    mgr.restore(other)
    want, got = flat(state), flat(other)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        if k == 'generator' or k.endswith('.step'):
            assert torch.equal(g, w), k
            continue
        low = torch.bfloat16 if k.startswith('opt.') else torch.float16
        assert torch.equal(g, w.to(low).to(w.dtype)), k


def test_fp16_ema_alone_keeps_the_weights_fp32(tmp_path):
    _, _, state, step = make()
    state = run(state, step, 1)
    mgr = CheckpointManager(str(tmp_path / 'c'), interval=1,
                            ckpt_fp16_ema=True, async_save=False)
    mgr.save(state)
    raw = load_raw_checkpoint(str(tmp_path / 'c'))
    assert all(t.dtype == torch.float32
               for t in raw['trainable']['diffusion'].values())
    assert all(t.dtype == torch.float16
               for t in raw['ema']['diffusion'].values())


def test_frozen_saved_unless_trainable_only(tmp_path):
    _, _, state, _ = make()
    state.frozen = {'teacher': {'w': torch.arange(6.0)}}
    mgr = CheckpointManager(str(tmp_path / 'c'), interval=0,
                            ckpt_trainable_only=False, async_save=False)
    assert not mgr.save(state) and mgr.save(state, force=True)
    state.frozen['teacher']['w'].zero_()
    mgr.restore(state)
    assert torch.equal(state.frozen['teacher']['w'], torch.arange(6.0))


def test_pruning_keeps_the_newest_and_the_must_save_steps(tmp_path):
    _, _, state, _ = make()
    mgr = CheckpointManager(str(tmp_path / 'c'), interval=2,
                            must_save_interval=6, max_keep_ckpts=2)
    for s in range(1, 15):
        state.step = s
        mgr.save(state)
    mgr.wait()
    assert sorted(int(d) for d in os.listdir(tmp_path / 'c')) == \
        [6, 12, 14]
    mgr2 = CheckpointManager(str(tmp_path / 'c'), interval=5,
                             max_keep_ckpts=1)
    state.step = 15
    mgr2.save(state)
    mgr2.wait()
    assert mgr2.latest_step() == 15
    assert os.listdir(tmp_path / 'c') == ['15']


def test_tmp_scheme_lies_under_the_temp_dir_not_dev_shm_unlike_jax(
        tmp_path, monkeypatch):
    """A divergence from the reference, kept on purpose: JAX stages
    ``tmp:name`` under ``/dev/shm`` whenever that exists
    (``arcflow_tpu/runner/checkpoint.py:39-42``); the port always uses
    ``tempfile.gettempdir()``. A container's ``/dev/shm`` is often 64 MB,
    and the trainable-only FLUX-12B checkpoint is 10.4 GB."""
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    assert resolve_checkpoint_dir('tmp:run1') == \
        (os.path.join(str(tmp_path), 'arcflow_ckpt', 'run1'), None)
    _, _, state, _ = make()
    mgr = CheckpointManager('tmp:run1', interval=1, async_save=False)
    state.step = 1
    mgr.save(state)
    assert os.path.isfile(tmp_path / 'arcflow_ckpt' / 'run1' / '1' /
                          'state.pt')
    assert load_raw_checkpoint('tmp:run1')['step'] == 1
    # s3:// mirrors (tests/test_torch_checkpoint_mirror.py) need boto3,
    # which this machine lacks: refused by name
    with pytest.raises(RuntimeError, match='boto3'):
        CheckpointManager('s3://bucket/run')


def test_a_save_killed_mid_write_is_never_picked(tmp_path):
    """A process whose write dies half way (``os._exit`` inside the file
    write): the step it was saving never appears; the next manager on the
    directory removes the partial write and restores the step before."""
    ckpt = str(tmp_path / 'c')
    code = textwrap.dedent(f'''
        import os, sys, torch
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {os.path.join(REPO, 'tests')!r})
        from test_torch_checkpoint import make, run
        from arcflow_tpu_torch.runner import CheckpointManager
        from arcflow_tpu_torch.runner import checkpoint as ck
        _, _, state, step = make()
        state = run(state, step, 2)
        mgr = CheckpointManager({ckpt!r}, interval=1, async_save=False)
        mgr.save(state)
        real_save = torch.save

        def dying_save(obj, path):
            real_save(obj, path)
            with open(path, 'r+b') as f:
                f.truncate(os.path.getsize(path) // 2)
            os._exit(9)
        ck.torch.save = dying_save
        state = run(state, step, 1)
        mgr.save(state)
    ''')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 9, res.stderr[-2000:]
    left = sorted(os.listdir(ckpt))      # '.partial-3-...', '2'
    assert len(left) == 2 and left[0].startswith('.partial-3-') and \
        left[1] == '2', left
    mgr = CheckpointManager(ckpt)
    assert mgr.latest_step() == 2 and os.listdir(ckpt) == ['2']
    _, _, state, _ = make(seed=4)
    mgr.restore(state)
    assert state.step == 2
