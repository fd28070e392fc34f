"""The ``tensor`` split on the card, against the same weights and inputs
unsplit on the card.

Marked ``cuda``: they skip without a CUDA device (K1-K5 have no CPU mode).
This file imports no JAX, so it runs where only the port is installed:
``python -m pytest --noconftest -q tests/test_torch_tensor_parallel_cuda.py``.

* ``LoRADense`` in column and row form on ``LocalTensor(2)`` in bf16,
  w8a8 (the int8 product on each shard's contiguous kernel) and w4a8 (K5
  at the shard's (K, N / 2) and (K / 2, N)), at 4096 tokens, against the
  unsplit layer on the card: a column split within 2e-3 relative L2; a
  row split in bf16 within 1e-2 (its two bf16 partials each round, then
  their sum: smoke phase 42 reads 2.9e-3 at a single block's proj_out)
  and quantized within 2e-3 (fp32 partials of the same integer products,
  rounded once); a row w8a8 / w4a8 layer whose shards quantize by their
  own absmax leaves that 2e-3.
* A small ArcFlux (2 + 4 blocks, 4 heads of 128: the kernels' head dim)
  in bf16 on ``LocalTensor(2)`` against the unsplit model on the card:
  ``means`` within 2e-2 relative L2 (bf16 partial sums through 6 blocks),
  K1 launched once per block and shard, and the adapter's gradients
  within 5e-2 relative L2 through K3 on each shard's heads.
"""

import copy

import pytest
import torch

from arcflow_tpu_torch.models import ArcFluxTransformer2DModel
from arcflow_tpu_torch.models.layers import LoRADense
from arcflow_tpu_torch.ops import attention as t_attn
from arcflow_tpu_torch.ops import quant_matmul as t_qmm
from arcflow_tpu_torch.parallel import LocalTensor, set_tensor_parallel
from arcflow_tpu_torch.parallel import tensor as tensor_par
from arcflow_tpu_torch.utils.quantize import (quantize_weights_int4,
                                              quantize_weights_int8)

LAYER_REL_L2 = 2e-3
BF16_ROW_REL_L2 = 1e-2
MODEL_REL_L2 = 2e-2
GRAD_REL_L2 = 5e-2
NET = dict(in_channels=16, num_layers=2, num_single_layers=4,
           attention_head_dim=128, num_attention_heads=4,
           joint_attention_dim=64, pooled_projection_dim=32,
           axes_dims_rope=(16, 56, 56), lora_rank=8, num_gaussians=4,
           checkpointing=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _rel(a, b):
    b = b.float()
    return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()


def _layer(mode, in_f, out_f):
    torch.manual_seed(0)
    holder = torch.nn.Module()
    holder.layer = LoRADense(in_f, out_f, lora_rank=8, device='cuda',
                             dtype=torch.bfloat16)
    with torch.no_grad():
        holder.layer.lora_b.normal_(std=0.02)
    if mode == 'w8a8':
        quantize_weights_int8(holder, min_size=1, act_quant=True)
    elif mode == 'w4a8':
        quantize_weights_int4(holder, min_size=1, act_quant=True)
    return holder.layer


@pytest.mark.cuda
@pytest.mark.parametrize('kind,segments', [('column', (3072,)),
                                           ('row', (3072,)),
                                           ('row', (1536, 1536))])
@pytest.mark.parametrize('mode', ['bf16', 'w8a8', 'w4a8'])
def test_lora_dense_split_on_the_card(cuda, mode, kind, segments):
    in_f = 3072
    one = _layer(mode, in_f, 3072)
    split = copy.deepcopy(one)
    split.split_tensor(LocalTensor(2), kind, segments)
    x = torch.randn(1, 4096, in_f, generator=cuda, device='cuda',
                    dtype=torch.bfloat16)
    x[..., :in_f // 2] *= 4.0
    launches = t_qmm.LAUNCHES
    with torch.inference_mode():
        want = one(x)
        if kind == 'column':
            got = torch.cat(split(x), dim=-1)
        else:
            parts = [tensor_par.take(x, -1, tensor_par.part_ranges(
                segments, 2, i)).contiguous() for i in range(2)]
            got = split(parts)
        split_launches = t_qmm.LAUNCHES - launches
        if kind == 'row' and mode != 'bf16':
            real = LocalTensor.all_max
            LocalTensor.all_max = lambda self, xs: xs
            try:
                planted = split(parts)
            finally:
                LocalTensor.all_max = real
            assert _rel(planted, want) > LAYER_REL_L2
    bound = BF16_ROW_REL_L2 if kind == 'row' and mode == 'bf16' \
        else LAYER_REL_L2
    assert _rel(got, want) <= bound, _rel(got, want)
    if mode == 'w4a8':
        assert split_launches == 3      # the whole layer's, two shards'


@pytest.mark.cuda
def test_small_arcflux_on_local_tensor(cuda):
    torch.manual_seed(0)
    model = ArcFluxTransformer2DModel(device='cuda', dtype=torch.bfloat16,
                                      **NET)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=cuda,
                                      device='cuda').to(p.dtype))
    split = copy.deepcopy(model)
    assert set_tensor_parallel(split, LocalTensor(2), min_size=1) == 18
    kw = dict(hidden_states=torch.randn(1, 64, 64, 4, generator=cuda,
                                        device='cuda'),
              t=torch.full((1,), 0.6, device='cuda'),
              encoder_hidden_states=torch.randn(
                  1, 128, 64, generator=cuda, device='cuda',
                  dtype=torch.bfloat16),
              pooled_projections=torch.randn(1, 32, generator=cuda,
                                             device='cuda',
                                             dtype=torch.bfloat16),
              guidance=torch.full((1,), 3.5, device='cuda'))
    outs, grads = [], []
    for m in (model, split):
        t_attn.LAUNCHES = 0
        out = m(**kw)
        (out['means'].float() ** 2).mean().backward()
        outs.append((out['means'].detach(), t_attn.LAUNCHES))
        grads.append({n: p.grad for n, p in m.named_parameters()
                      if 'lora' in n and p.grad is not None})
    assert outs[0][1] == 6 and outs[1][1] == 12
    assert _rel(outs[1][0], outs[0][0]) <= MODEL_REL_L2
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for n, g in grads[0].items():
        assert _rel(grads[1][n], g) <= GRAD_REL_L2, n
