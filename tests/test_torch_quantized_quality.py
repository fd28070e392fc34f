"""Quality gate of the port's int8 and int4 modes on a trained toy: the
mirror of ``tests/test_quantized_quality.py`` on the CPU.

A flow teacher and a 2-NFE ArcFlow student are trained through
``train_model`` with that file's cuts (hidden (128, 128), the 2 x 2 board,
2500 and 800 iterations). The student, served with its trunk quantized by
``utils/quantize.py`` (weight-only int8, w8a8, weight-only int4 in groups
of 32, w4a8), and students distilled from an int8 and an int4 teacher
(``Distillation2D(teacher_quant=)``), must hold the fp32 student's
in-support share within that file's margins: 0.05 (int8), 0.08 (w8a8 and
the int8 teacher), 0.10 (int4, w4a8 and the int4 teacher), every share
above 0.6.
"""

import copy
import os

import pytest
import torch

from arcflow_tpu_torch import Config
from arcflow_tpu_torch.apis import train_model
from arcflow_tpu_torch.data import CheckerboardData
from arcflow_tpu_torch.models.layers import LoRADense
from arcflow_tpu_torch.utils.quantize import (quantize_weights_int4,
                                              quantize_weights_int8)

torch.set_num_threads(2)

CFG_DIR = os.path.join(os.path.dirname(__file__), '..', 'configs', 'toy')
DISTILL = {'model.diffusion.denoising.hidden': (128, 128),
           'model.teacher.denoising.hidden': (128, 128),
           'data.train.n_rc': 2,
           'data.train_dataloader.samples_per_gpu': 256,
           'total_iters': 800,
           'train_cfg.num_decay_iters': 300,
           'checkpoint_config.interval': 800,
           'log_config.interval': 400}


def distill(work_dir, teacher_ckpt, **opts):
    cfg = Config.fromfile(os.path.join(CFG_DIR,
                                       'checkerboard_arcflow_2nfe.py'))
    cfg.merge_from_dict(dict(DISTILL, **{'model.teacher_ckpt': teacher_ckpt},
                             **opts))
    cfg.work_dir = str(work_dir)
    return train_model(cfg, seed=0, device='cpu')


@pytest.fixture(scope='module')
def distilled(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp('quantq')
    cfg = Config.fromfile(os.path.join(CFG_DIR, 'checkerboard_flow.py'))
    cfg.merge_from_dict({
        'model.diffusion.denoising.hidden': (128, 128),
        'data.train.n_rc': 2,
        'data.train_dataloader.samples_per_gpu': 512,
        'total_iters': 2500,
        'checkpoint_config.interval': 2500,
        'log_config.interval': 1000,
    })
    cfg.work_dir = str(tmp_path / 'flow')
    train_model(cfg, seed=0, device='cpu')
    teacher = os.path.join(cfg.work_dir, 'checkpoints', 'checkerboard_flow')
    state, model = distill(tmp_path / 'distill', teacher)
    return dict(state=state, model=model, teacher=teacher,
                tmp_path=tmp_path)


def in_support(diffusion, denoiser, n=2048, seed=7):
    """In-support share of ``n`` 2-NFE samples of ``diffusion`` run with
    ``denoiser``, from fixed noise."""
    d = copy.copy(diffusion)
    d.denoising = denoiser
    noise = torch.randn(n, 2, generator=torch.Generator().manual_seed(seed))
    samples = d.forward_test(noise).numpy()
    return float(CheckerboardData(n_rc=2).log_prob_support(samples).mean())


def ema_denoiser(state, model):
    """A copy of the student's denoiser holding its EMA weights."""
    den = copy.deepcopy(model.diffusion.denoising)
    den.load_state_dict(state.ema['diffusion'], strict=True)
    return den


def test_quantized_serving_quality(distilled):
    state, model = distilled['state'], distilled['model']
    den = ema_denoiser(state, model)
    base = in_support(model.diffusion, den)
    assert base > 0.6, f'fp32 student only {base:.2%} in support'
    shares = {}
    for mode, quantize, kw in (
            ('int8', quantize_weights_int8, dict(act_quant=False)),
            ('w8a8', quantize_weights_int8, dict(act_quant=True)),
            ('int4', quantize_weights_int4, dict(act_quant=False,
                                                 group_size=32)),
            ('w4a8', quantize_weights_int4, dict(act_quant=True,
                                                 group_size=32))):
        q = copy.deepcopy(den)
        names = quantize(q, min_size=1024, **kw)
        assert len(names) >= 1, mode
        assert all(getattr(q.get_submodule(n), 'act_quant') == kw['act_quant']
                   for n in names)
        shares[mode] = in_support(model.diffusion, q)
    print(f'in-support: fp32 {base:.4f}, ' + ', '.join(
        f'{m} {v:.4f}' for m, v in shares.items()))
    margins = dict(int8=0.05, w8a8=0.08, int4=0.10, w4a8=0.10)
    for mode, share in shares.items():
        assert abs(base - share) < margins[mode], (mode, base, shares)


@pytest.mark.parametrize('quant, margin', [('int8', 0.08), ('int4', 0.10)])
def test_quantized_teacher_distillation_quality(distilled, quant, margin):
    base = in_support(distilled['model'].diffusion,
                      ema_denoiser(distilled['state'], distilled['model']))
    opts = {'model.teacher_quant': quant}
    if quant == 'int4':
        opts['model.teacher_quant_group_size'] = 32
    state, model = distill(distilled['tmp_path'] / f'distill_{quant}',
                           distilled['teacher'], **opts)
    kind = dict(int8='kernel', int4='kernel_packed4')[quant]
    teacher = model.init_params()[1]['teacher']
    assert any(n.endswith(kind) for n in teacher), sorted(teacher)[:5]
    assert any(isinstance(m, LoRADense) and m.is_quantized
               for m in model.teacher.denoising.modules())
    q = in_support(model.diffusion, ema_denoiser(state, model))
    print(f'in-support: fp32-teacher student {base:.4f}, {quant}-teacher '
          f'student {q:.4f}')
    assert q > 0.6, f'{quant}-teacher student only {q:.2%} in support'
    assert abs(base - q) < margin, (base, q)
