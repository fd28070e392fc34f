"""The class-conditional ImageNet path on the card against the CPU: the
ArcFlow UNet's forward, one step of each high-order solver and one
distillation step of ``LatentDiffusionClassImage`` (teacher CFG 1.5,
loss and gradients), at small width, the same weights and draws on both
sides, fp32 with TF32 off. No hand-written kernel runs on this path (the
UNet's attention is ``F.scaled_dot_product_attention``, as the JAX
module's is XLA's).

Marked ``cuda``: they skip without a CUDA device. This file imports no
JAX: ``python -m pytest --noconftest -q tests/test_torch_imagenet_cuda.py``.
Tolerances: the UNet outputs within 1e-4 relative L2 (cuDNN's fp32
convolution algorithms sum in another order than the CPU's), the solver
steps within 1e-5 absolute, the loss within 1e-4 relative and the
gradients together within 1e-3 relative L2 (two NFE segments of
rollouts carry the sums' rounding further).
"""

import contextlib
from unittest import mock

import pytest
import torch

from arcflow_tpu_torch.diffusion.schedulers import (
    FlowDEISScheduler, FlowDPMSolverScheduler, FlowSASolverScheduler,
    FlowUniPCScheduler)
from arcflow_tpu_torch.models import (ArcDenoisingUnetMod,
                                      LatentDiffusionClassImage)

pytestmark = pytest.mark.cuda

UNET = dict(in_channels=4, base_channels=32, channel_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(4,), num_classes=10,
            num_heads=4)
LAT = (8, 8, 4)
UNET_REL_L2, STEP_ATOL, LOSS_RTOL, GRAD_REL_L2 = 1e-4, 1e-5, 1e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


@contextlib.contextmanager
def cpu_draws(seed):
    """torch.rand / torch.randn drawn on the CPU from one seeded generator
    and moved to the asked device, so both sides draw the same numbers."""
    real = dict(rand=torch.rand, randn=torch.randn)
    gen = torch.Generator().manual_seed(seed)

    def make(kind):
        def fn(*size, generator=None, device=None, dtype=None, **kwargs):
            if len(size) == 1 and not isinstance(size[0], int):
                size = tuple(size[0])
            return real[kind](size, generator=gen, dtype=dtype).to(device)
        return fn
    with mock.patch.object(torch, 'rand', make('rand')), \
            mock.patch.object(torch, 'randn', make('randn')):
        yield


def test_arc_unet_forward_on_card_matches_cpu(cuda):
    torch.manual_seed(0)
    cpu = ArcDenoisingUnetMod(**UNET, num_gaussians=4, data_shape=LAT,
                              device='cpu')
    with torch.no_grad():          # live heads and residual convs
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn_like(p))
    card = ArcDenoisingUnetMod(**UNET, num_gaussians=4, data_shape=LAT,
                               device='cuda')
    card.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.randn(3, *LAT)
    t = torch.tensor([10.0, 500.0, 990.0])
    y = torch.tensor([1, 10, 4])
    with torch.no_grad():
        want = cpu(x, t, label=y)
        got = card(x.cuda(), t.cuda(), label=y.cuda())
    for k in want:
        assert got[k].is_cuda and got[k].shape == want[k].shape
        assert rel_l2(got[k], want[k]) < UNET_REL_L2, k


@pytest.mark.parametrize('cls,kw', [(FlowDPMSolverScheduler, {}),
                                    (FlowUniPCScheduler, {}),
                                    (FlowDEISScheduler, {}),
                                    (FlowSASolverScheduler, dict(tau=0.0))])
def test_solver_steps_on_card_match_cpu(cuda, cls, kw):
    sched = cls(**kw)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, *LAT, generator=g)
    outs = [torch.randn(4, *LAT, generator=g) for _ in range(3)]
    sigmas = sched.set_timesteps(3)
    res = {}
    for dev in ('cpu', 'cuda'):
        xd = x.to(dev)
        state = sched.init_state(xd)
        for out, s, s_next in zip(outs, sigmas[:-1], sigmas[1:]):
            xd, state = sched.step_with_state(out.to(dev), xd, s, s_next,
                                              state)
        res[dev] = xd
    assert res['cuda'].is_cuda
    torch.testing.assert_close(res['cuda'].cpu(), res['cpu'], rtol=0,
                               atol=STEP_ATOL)


def _class_image(device):
    torch.manual_seed(0)
    return LatentDiffusionClassImage(
        diffusion=dict(
            type='ArcFlowImitationDataFree', policy_type='ArcFlow',
            denoising=dict(type='ArcDenoisingUnetMod', num_gaussians=4,
                           **UNET),
            flow_loss=dict(type='DiffusionMSELoss',
                           data_info=dict(pred='u_t_pred', target='u_t'),
                           rescale_cfg=dict(scale=30.0)),
            num_timesteps=1),
        teacher=dict(type='GaussianFlow',
                     denoising=dict(type='DenoisingUnetMod', **UNET),
                     num_timesteps=1),
        num_classes=10, prob_class=0.0, latent_shape=LAT,
        student_init_from_teacher=True,
        train_cfg=dict(nfe=2, total_substeps=32, num_intermediate_states=2,
                       window_substeps=3, gm_dropout=0.1,
                       teacher_guidance_scale=1.5),
        device=device)


def test_distillation_step_on_card_matches_cpu(cuda):
    cpu = _class_image('cpu')
    card = _class_image('cuda')
    card.diffusion.denoising.load_state_dict(
        cpu.diffusion.denoising.state_dict(), strict=True)
    card.teacher.denoising.load_state_dict(
        cpu.teacher.denoising.state_dict(), strict=True)
    g = torch.Generator().manual_seed(2)
    batch = dict(latents=torch.randn(4, *LAT, generator=g),
                 label=torch.tensor([0, 3, 7, 9]))
    res = {}
    for dev, model in (('cpu', cpu), ('cuda', card)):
        with cpu_draws(3):
            loss, _ = model.loss({k: v.to(dev) for k, v in batch.items()},
                                 torch.Generator(dev),
                                 running_status=dict(iteration=10))
        loss.backward()
        grads = torch.cat([p.grad.reshape(-1).cpu() for p in
                           model.init_params()[0]['diffusion'].values()])
        res[dev] = (loss.detach().cpu(), grads)
    torch.testing.assert_close(res['cuda'][0], res['cpu'][0], rtol=LOSS_RTOL,
                               atol=0)
    assert rel_l2(res['cuda'][1], res['cpu'][1]) < GRAD_REL_L2
