"""Mesh training on the card: a FLUX-width ArcFlux distillation (one joint
and one single block of 24 heads x 128, LoRA, checkpointing, LoRA dropout)
sharded with ``parallel.shard_model`` over a mesh of one device (FSDP2 at
world size 1, NCCL in a process group of one) against the same composition
unsharded, through the attention kernels K1 and K3.

Marked ``cuda``: it skips without a CUDA device. This file imports no
JAX: ``python -m pytest --noconftest -q tests/test_torch_mesh_train_cuda.py``.
At world size 1 FSDP2's all-gather and reduce-scatter copy, so the loss,
every adapter gradient and the launch counts must equal the unsharded ones
bit for bit.
"""

import pytest
import torch
import torch.distributed as dist

from arcflow_tpu_torch.models import LatentDiffusionTextImage
from arcflow_tpu_torch.ops import attention as attn
from arcflow_tpu_torch.parallel import make_mesh, setup_distributed, shard_model
from arcflow_tpu_torch.parallel.fsdp import is_sharded

NET = dict(in_channels=64, num_layers=1, num_single_layers=1,
           attention_head_dim=128, num_attention_heads=24,
           joint_attention_dim=256, pooled_projection_dim=64,
           axes_dims_rope=(16, 56, 56), guidance_embeds=True,
           checkpointing=True)
# forwards per loss: 2 student + 2 x 2 teacher + 2 recomputed by
# checkpointing, each through both blocks; backwards: 2 x 2
FORWARDS, BACKWARDS = (2 + 2 * 2 + 2) * 2, 2 * 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    setup_distributed()                 # a process group of one
    yield
    dist.destroy_process_group()


def _model():
    torch.manual_seed(0)
    return LatentDiffusionTextImage(
        diffusion=dict(
            type='ArcFlowImitationDataFree', policy_type='ArcFlow',
            denoising=dict(type='ArcFluxTransformer2DModel', patch_size=2,
                           num_gaussians=4, lora_rank=8, lora_dropout=0.05,
                           **NET),
            flow_loss=dict(type='DiffusionMSELoss',
                           data_info=dict(pred='u_t_pred', target='u_t'),
                           rescale_cfg=dict(scale=30.0)),
            num_timesteps=1,
            timestep_sampler=dict(type='ContinuousTimeStepSampler',
                                  shift=3.2)),
        teacher=dict(type='GaussianFlow',
                     denoising=dict(type='FluxTransformer2DModel',
                                    patch_size=2, **NET),
                     num_timesteps=1),
        tie_teacher=True, latent_shape=(32, 32, 16), text_embed_dim=256,
        pooled_dim=64, frozen_dtype='bfloat16', device='cuda',
        dtype=torch.bfloat16,
        train_cfg=dict(nfe=2, timestep_ratio=1.0, total_substeps=128,
                       num_intermediate_states=2, window_substeps=3,
                       gm_dropout=0.1, num_decay_iters=100,
                       distilled_guidance_scale=3.5,
                       teacher_distilled_guidance_scale=3.5))


def _loss_and_grads(sharded):
    model = _model()
    with torch.no_grad():               # live heads and LoRA
        g = torch.Generator(device='cuda').manual_seed(1)
        for p in model.init_params()[0]['diffusion'].values():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device='cuda'))
    if sharded:
        shard_model(model, make_mesh({'data': 1, 'fsdp': -1}))
    g = torch.Generator(device='cuda').manual_seed(2)
    batch = dict(
        latents=torch.zeros(1, 32, 32, 16, device='cuda'),
        prompt_embed_kwargs=dict(
            encoder_hidden_states=torch.randn(1, 16, 256, generator=g,
                                              device='cuda'),
            pooled_projections=torch.randn(1, 64, generator=g,
                                           device='cuda')))
    attn.LAUNCHES = attn.BWD_LAUNCHES = 0
    loss, _ = model.loss(batch, torch.Generator(device='cuda').manual_seed(3),
                         running_status=dict(iteration=0))
    loss.backward()
    torch.cuda.synchronize()
    adapter = model.init_params()[0]['diffusion']
    grads = {n: (p.grad.full_tensor() if is_sharded(p.grad) else p.grad)
             for n, p in adapter.items()}
    return (loss.item(), grads, (attn.LAUNCHES, attn.BWD_LAUNCHES),
            sum(is_sharded(p) for p in adapter.values()))


@pytest.mark.cuda
def test_sharded_block_trains_as_the_unsharded_one(cuda):
    loss, grads, launches, _ = _loss_and_grads(False)
    s_loss, s_grads, s_launches, n_sharded = _loss_and_grads(True)
    assert launches == s_launches == (FORWARDS, BACKWARDS)
    assert n_sharded == len(grads)
    assert s_loss == loss
    for n, g in grads.items():
        assert torch.equal(s_grads[n], g), n
