"""The pipeline schedule and the MoE FFN on the card, against the same
weights and inputs on the CPU.

Marked ``cuda``: they skip without a CUDA device (the attention kernels
inside the blocks have no CPU mode). This file imports no JAX, so it runs
where only the port is installed: ``python -m pytest --noconftest -q
tests/test_torch_pipe_expert_cuda.py``.

* ``MoEFeedForward`` (E 4, D 256, 512 tokens) in fp32 on the card (TF32
  off) against the CPU: output within rtol 1e-4, atol 1e-5, each gradient
  within 1e-5 relative L2 (fp32 sums over the tokens in another order: an
  element that cancels to near 0 keeps the sums' absolute error, 1.5e-5
  on one of the router's 1024 in a run, so elements are not compared);
  in bf16 on the same bf16 tokens within 2e-2 relative L2 of the CPU's
  bf16 (each side rounds its products to
  bf16 in its own order: a few bf16 ulps over two matmuls). At capacity 4
  every expert takes every token: at a lower one, a token whose score
  sits at an expert's cut may be picked on one side and not the other
  from the last bit of an fp32 sum.
* A small ArcFlux (2 + 4 blocks, 2 heads of 128: the kernels' head dim) in
  bf16 with its stacks on ``LocalPipe(2)`` at M = 2 against the plain loop
  on the card (K1 and K3 in both): ``means`` and the adapter's gradients
  within 2e-2 relative L2, the circular schedule (V = 2) too, and K1 / K3
  launched once per block and microbatch.
"""

import pytest
import torch

from arcflow_tpu_torch.models import ArcFluxTransformer2DModel
from arcflow_tpu_torch.models.layers import MoEFeedForward
from arcflow_tpu_torch.ops import attention as t_attn
from arcflow_tpu_torch.parallel import LocalPipe, set_pipe

F32_TOL = dict(rtol=1e-4, atol=1e-5)
F32_GRAD_REL_L2 = 1e-5
REL_L2 = 2e-2
NET = dict(in_channels=16, num_layers=2, num_single_layers=4,
           attention_head_dim=128, num_attention_heads=2,
           joint_attention_dim=64, pooled_projection_dim=32,
           axes_dims_rope=(16, 56, 56), lora_rank=8, num_gaussians=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _rel(a, b):
    b = b.float()
    return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()


def _moe_run(moe, x):
    x = x.clone().requires_grad_()
    y = moe(x)
    (y.float() ** 2).sum().backward()
    return y.detach(), x.grad, {n: p.grad for n, p in moe.named_parameters()}


@pytest.mark.cuda
def test_moe_on_the_card_matches_the_cpu(cuda):
    moe = MoEFeedForward(256, 4, 4.0, mult=4, dtype=torch.float32)
    x = torch.randn(2, 512, 256, generator=cuda)
    want = _moe_run(moe, x)
    card = MoEFeedForward(256, 4, 4.0, mult=4, dtype=torch.float32,
                          device='cuda')
    card.load_state_dict(moe.state_dict())
    got = _moe_run(card, x.cuda())
    torch.testing.assert_close(got[0].cpu(), want[0], **F32_TOL)
    assert _rel(got[1].cpu(), want[1]) <= F32_GRAD_REL_L2
    for n in want[2]:
        assert _rel(got[2][n].cpu(), want[2][n]) <= F32_GRAD_REL_L2, n
    # bf16: the same bf16 tokens on both sides
    low_cpu = MoEFeedForward(256, 4, 4.0, mult=4, dtype=torch.bfloat16)
    low_cpu.load_state_dict(moe.state_dict())
    want = _moe_run(low_cpu, x.bfloat16())
    bf16 = MoEFeedForward(256, 4, 4.0, mult=4, dtype=torch.bfloat16,
                          device='cuda')
    bf16.load_state_dict(moe.state_dict())
    low = _moe_run(bf16, x.cuda().bfloat16())
    assert _rel(low[0].cpu(), want[0]) <= REL_L2
    for n in want[2]:
        assert _rel(low[2][n].cpu(), want[2][n]) <= REL_L2, n


def _flux_inputs(g):
    f = dict(device='cuda', dtype=torch.bfloat16)
    return dict(hidden_states=torch.randn(2, 16, 16, 4, generator=g).to(**f),
                t=torch.tensor([0.7, 0.3], device='cuda'),
                encoder_hidden_states=torch.randn(2, 24, 64,
                                                  generator=g).to(**f),
                pooled_projections=torch.randn(2, 32, generator=g).to(**f),
                guidance=torch.full((2,), 3.5, device='cuda'))


def _flux_run(model, inp, pipe):
    set_pipe(model, pipe)
    model.zero_grad()
    before = (t_attn.LAUNCHES, t_attn.BWD_LAUNCHES)
    out = model(**inp, dropout_seed=5)
    sum((v.float() ** 2).sum() for v in out.values()).backward()
    torch.cuda.synchronize()
    set_pipe(model, None)
    counts = (t_attn.LAUNCHES - before[0], t_attn.BWD_LAUNCHES - before[1])
    grads = torch.cat([p.grad.flatten().float()
                       for n, p in model.named_parameters()
                       if 'lora' in n and p.grad is not None])
    return out['means'].detach(), grads, counts


@pytest.mark.cuda
@pytest.mark.parametrize('interleave', [1, 2])
def test_local_pipe_on_the_card_is_the_plain_loop(cuda, interleave):
    """2 joint blocks (2 % 2 == 0: staged too) and 4 single blocks at M =
    2: every block runs once per microbatch, K1 in the forward and K3 in
    the backward (no checkpointing)."""
    torch.manual_seed(0)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16,
                                          checkpointing=False,
                                          lora_dropout=0.1, **NET)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 0.05)
    inp = _flux_inputs(cuda)
    want, want_g, plain_counts = _flux_run(model, inp, None)
    got, got_g, counts = _flux_run(model, inp, LocalPipe(2, 2, interleave))
    blocks = NET['num_layers'] + NET['num_single_layers']
    assert plain_counts == (blocks, blocks)
    assert counts == (2 * blocks, 2 * blocks)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= REL_L2
    assert _rel(got_g, want_g) <= REL_L2
