"""End-to-end slice of the port on the CPU: config -> flow training ->
checkpoint resume -> ArcFlow distillation with the trained teacher -> 2-NFE
samples in support.

The port's mirror of ``tests/test_e2e_checkerboard.py``, with its cuts
(hidden (128, 128), the 2 x 2 board, 3000 flow iterations at batch 512,
800 distillation iterations at batch 256 with the teacher-ratio decay over
300) and its thresholds: more than 75% of the flow model's samples (32
Euler steps, EMA weights) and more than 50% of the 2-NFE student's in the
board's support.
"""

import os

import numpy as np
import pytest
import torch

from arcflow_tpu_torch import Config
from arcflow_tpu_torch.apis import train_model
from arcflow_tpu_torch.data import CheckerboardData

torch.set_num_threads(2)

CFG_DIR = os.path.join(os.path.dirname(__file__), '..', 'configs', 'toy')


def small_flow_cfg(work_dir, total_iters=3000):
    cfg = Config.fromfile(os.path.join(CFG_DIR, 'checkerboard_flow.py'))
    cfg.merge_from_dict({
        'model.diffusion.denoising.hidden': (128, 128),
        'data.train.n_rc': 2,
        'data.train_dataloader.samples_per_gpu': 512,
        'total_iters': total_iters,
        'checkpoint_config.interval': 1000,
        'log_config.interval': 1000,
    })
    cfg.work_dir = str(work_dir)
    return cfg


def in_support(model, state, seed, n, **kwargs):
    samples = model.val_step(dict(num_samples=n),
                             torch.Generator().manual_seed(seed),
                             ema=state.ema['diffusion'], **kwargs)
    samples = samples.numpy()
    assert samples.shape == (n, 2) and np.isfinite(samples).all()
    return CheckerboardData(n_rc=2).log_prob_support(samples).mean()


@pytest.fixture(scope='module')
def trained_flow(tmp_path_factory):
    work_dir = tmp_path_factory.mktemp('e2e') / 'flow'
    cfg = small_flow_cfg(work_dir)
    state, model = train_model(cfg, seed=0, device='cpu')
    return cfg, state, model


def test_flow_training_and_sampling(trained_flow):
    cfg, state, model = trained_flow
    assert state.step == 3000
    share = in_support(model, state, 0, 2048,
                       test_cfg_override=dict(num_timesteps=32))
    assert share > 0.75, f'only {share:.2%} of samples in support'


def test_resume_from_checkpoint(trained_flow):
    cfg, state, model = trained_flow
    cfg2 = small_flow_cfg(cfg.work_dir, total_iters=3010)
    state2, _ = train_model(cfg2, seed=0, device='cpu')
    assert state2.step == 3010
    # resumed from where training left off, not from a fresh init
    name = 'LoRADense_0.weight'
    w_before = state.trainable['diffusion'][name]
    w_after = state2.trainable['diffusion'][name]
    assert (w_before - w_after).abs().max() < 1.0
    assert not torch.equal(w_before, w_after)


def test_offload_cold_state_is_refused(tmp_path):
    cfg = small_flow_cfg(tmp_path, total_iters=2)
    cfg.merge_from_dict({'train_cfg.offload_cold_state': True})
    with pytest.raises(NotImplementedError, match='offload_cold_state'):
        train_model(cfg, device='cpu')


def test_distillation_with_trained_teacher(trained_flow, tmp_path):
    cfg_flow, _, _ = trained_flow
    cfg = Config.fromfile(os.path.join(CFG_DIR,
                                       'checkerboard_arcflow_2nfe.py'))
    cfg.merge_from_dict({
        'model.teacher_ckpt': os.path.join(cfg_flow.work_dir, 'checkpoints',
                                           'checkerboard_flow'),
        'model.diffusion.denoising.hidden': (128, 128),
        'model.teacher.denoising.hidden': (128, 128),
        'data.train.n_rc': 2,
        'data.train_dataloader.samples_per_gpu': 256,
        'total_iters': 800,
        'train_cfg.num_decay_iters': 300,
        'checkpoint_config.interval': 800,
        'log_config.interval': 400,
    })
    cfg.work_dir = str(tmp_path / 'distill')
    state, model = train_model(cfg, seed=0, device='cpu')
    assert state.step == 800
    share = in_support(model, state, 1, 1024)
    assert share > 0.5, f'only {share:.2%} of 2-NFE samples in support'
