"""Qwen distillation on the card: the loss and adapter gradients of a tiny
int8-trunk ``LatentDiffusionTextImage`` through the masked attention
kernels (K2 forward, K3 backward) against the same weights and draws
through their plain versions, the launch counts, and the tied teacher in
the student's storage; the VAE encoders on the card against the CPU.

Marked ``cuda``: they skip without a CUDA device. This file imports no
JAX: ``python -m pytest --noconftest -q tests/test_torch_qwen_train_cuda.py``.
Tiny widths, except the head dimension of 128 the attention kernels take.
Tolerances: the loss and all adapter gradients together within 5e-2
relative L2, ``chip_smoke.py``'s TRAIN_SLICE_REL_L2 (bf16 rounding of P
and dS in the kernels); the encoders within 2e-2 relative L2 of the fp32
CPU result (bf16 convolutions on the card: a few bf16 roundings, 2^-8
each).
"""

from unittest import mock

import pytest
import torch

from arcflow_tpu_torch.models import (LatentDiffusionTextImage,
                                      PretrainedVAEEncoder,
                                      PretrainedVAEQwenImage)
from arcflow_tpu_torch.ops import attention as attn

NET = dict(in_channels=16, num_layers=2, attention_head_dim=128,
           num_attention_heads=2, joint_attention_dim=64,
           axes_dims_rope=(16, 56, 56), max_text_len=16)
TRAIN_CFG = dict(nfe=2, timestep_ratio=1.0, total_substeps=128,
                 num_intermediate_states=2, window_substeps=3,
                 gm_dropout=0.1, num_decay_iters=100,
                 teacher_guidance_scale=4.0)
# forwards per loss: 2 student + 2 x 2 teacher (CFG as one batch of 2) +
# 2 recomputed by checkpointing; backwards: 2
FORWARDS, BACKWARDS = 2 + 2 * 2 + 2, 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.Generator(device='cuda').manual_seed(0)


def _model():
    torch.manual_seed(0)
    model = LatentDiffusionTextImage(
        diffusion=dict(
            type='ArcFlowImitationDataFree', policy_type='ArcFlow',
            denoising=dict(type='ArcQwenImageTransformer2DModel',
                           patch_size=2, num_gaussians=4, lora_rank=4,
                           lora_dropout=0.05, checkpointing=True, **NET),
            flow_loss=dict(type='DiffusionMSELoss',
                           data_info=dict(pred='u_t_pred', target='u_t'),
                           rescale_cfg=dict(scale=30.0)),
            num_timesteps=1,
            timestep_sampler=dict(type='ContinuousTimeStepSampler',
                                  shift=3.0)),
        teacher=dict(type='GaussianFlow',
                     denoising=dict(type='QwenImageTransformer2DModel',
                                    patch_size=2, **NET),
                     num_timesteps=1),
        latent_shape=(16, 16, 4), text_embed_dim=64, max_text_len=16,
        frozen_dtype='bfloat16', frozen_quant='int8',
        frozen_quant_min_size=1024, train_cfg=TRAIN_CFG, device='cuda')
    with torch.no_grad():                    # live heads and LoRA
        g = torch.Generator(device='cuda').manual_seed(1)
        for p in model.init_params()[0]['diffusion'].values():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device='cuda'))
    return model


def _batch(g):
    mask = (torch.arange(16, device='cuda')[None] < torch.tensor(
        [[11], [16]], device='cuda')).long()
    return dict(
        latents=torch.randn(2, 16, 16, 4, generator=g, device='cuda'),
        prompt_embed_kwargs=dict(
            encoder_hidden_states=torch.randn(2, 16, 64, generator=g,
                                              device='cuda'),
            encoder_hidden_states_mask=mask),
        negative_prompt_embed_kwargs=dict(
            encoder_hidden_states=torch.randn(2, 16, 64, generator=g,
                                              device='cuda'),
            encoder_hidden_states_mask=torch.ones_like(mask)))


def _loss_and_grads(model, batch):
    adapter = model.init_params()[0]['diffusion']
    for p in adapter.values():
        p.grad = None
    loss, _ = model.loss(batch, torch.Generator(device='cuda').manual_seed(2),
                         running_status=dict(iteration=0))
    loss.backward()
    return loss.item(), torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
        for p in adapter.values()])


@pytest.mark.cuda
def test_masked_kernels_train_qwen_as_the_plain_versions(cuda):
    model = _model()
    batch = _batch(cuda)
    before = (attn.LAUNCHES, attn.BWD_LAUNCHES)
    loss_k, grads_k = _loss_and_grads(model, batch)
    torch.cuda.synchronize()
    assert (attn.LAUNCHES - before[0], attn.BWD_LAUNCHES - before[1]) == (
        FORWARDS * NET['num_layers'], BACKWARDS * NET['num_layers'])

    def plain_fwd(q, k, v, kv_valid=None, return_lse=False):
        return attn.attention_ref(q, k, v, kv_valid, return_lse)
    with mock.patch.object(attn, 'flash_attention_fwd', plain_fwd), \
            mock.patch.object(attn, 'flash_attention_bwd',
                              attn.attention_bwd_ref):
        loss_p, grads_p = _loss_and_grads(model, batch)
    assert torch.isfinite(grads_k).all()
    assert abs(loss_k - loss_p) / abs(loss_p) <= 5e-2
    assert ((grads_k - grads_p).norm() / grads_p.norm()).item() <= 5e-2


@pytest.mark.cuda
def test_tied_teacher_lies_in_the_students_int8_storage(cuda):
    model = _model()
    student = model.diffusion.denoising.state_dict(keep_vars=True)
    teacher = model.teacher.denoising.state_dict(keep_vars=True)
    trunk = [n for n in teacher if not n.startswith(('proj_out.',
                                                     'norm_out.'))]
    assert any(teacher[n].dtype == torch.int8 for n in trunk)
    for n in trunk:
        assert teacher[n].device.type == 'cuda'
        assert teacher[n].data_ptr() == student[n].data_ptr(), n


@pytest.mark.cuda
@pytest.mark.parametrize('family', ['flux', 'wan'])
def test_encoders_on_the_card_match_the_cpu(cuda, family):
    kw = dict(latent_channels=4, block_out_channels=(32, 64),
              layers_per_block=1) if family == 'flux' else dict(
        base_dim=32, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1)
    torch.manual_seed(0)
    cpu = PretrainedVAEEncoder(**kw) if family == 'flux' else \
        PretrainedVAEQwenImage(with_encoder=True, **kw)
    card = (PretrainedVAEEncoder(device='cuda', dtype=torch.bfloat16, **kw)
            if family == 'flux' else PretrainedVAEQwenImage(
                with_encoder=True, device='cuda', dtype=torch.bfloat16, **kw))
    card.load_state_dict(cpu.state_dict(), strict=True)
    img = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(3)
                     ) * 2 - 1
    with torch.no_grad():
        want = cpu.encode(img)
        got = card.encode(img.to('cuda')).cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ((got - want).norm() / want.norm()).item() <= 2e-2
