"""The ring's backward on the card: n K3 hops per shard of a ``LocalRing``
against the plain attention backward of the whole sequence.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). This file imports no JAX, so it runs where only the port is
installed: ``python -m pytest --noconftest -q tests/test_torch_sp_train_cuda.py``.

At the FLUX-12B hop shape (B1, S 4608 cut into 4 shards of 1152, H24,
D128, bf16): the ring's forward (16 K4 hops) and backward (16 K3 hops, each
with the shard's global O and LSE) give dq, dk and dv within
``chip_smoke.py``'s K3 bound (relative L2 2e-2 each) of
``attention_bwd_ref`` on the whole sequence with the ring's O and LSE,
unmasked and with the Qwen layout's key mask (4480 of 4608 keys valid).
A row with no valid key gets dq = dk = 0 and dv = sum dO / S at every key.
A planted fault, one block's dK / dV accumulators not sent home, must
break the bound.
"""

import importlib

import pytest
import torch

from arcflow_tpu_torch.ops import attention as t_attn
from arcflow_tpu_torch.ops import ring_hop as t_hop
from arcflow_tpu_torch.parallel import LocalRing, ring_attention

SHAPE = (1, 4608, 24, 128)
SP = 4
REL_L2 = 2e-2
ring_mod = importlib.import_module('arcflow_tpu_torch.parallel.ring_attention')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _ring_grads(q, k, v, do, valid):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out, lse = ring_attention(*leaves, valid, LocalRing(SP), return_lse=True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    return out.detach(), lse, grads


@pytest.mark.cuda
@pytest.mark.parametrize('valid_keys', [None, 4480])
def test_ring_backward_against_plain_backward(cuda, valid_keys):
    q, k, v, do = (torch.randn(SHAPE, generator=cuda, device='cuda',
                               dtype=torch.bfloat16) for _ in range(4))
    valid = None if valid_keys is None else \
        (torch.arange(SHAPE[1], device='cuda') < valid_keys)[None]
    before = (t_hop.LAUNCHES, t_attn.BWD_LAUNCHES, t_attn.LAUNCHES)
    out, lse, got = _ring_grads(q, k, v, do, valid)
    launches = (t_hop.LAUNCHES - before[0], t_attn.BWD_LAUNCHES - before[1],
                t_attn.LAUNCHES - before[2])
    assert launches == (SP * SP, SP * SP, 0)
    want = t_attn.attention_bwd_ref(q, k, v, out, do, lse, valid)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= REL_L2, (name, _rel(g, w))
    if valid is not None:
        assert not got[1][:, valid_keys:].any()
        assert not got[2][:, valid_keys:].any()


@pytest.mark.cuda
def test_keyless_row_gets_the_mean_of_do(cuda):
    b, s, h = 2, 1152, 4
    q, k, v, do = (torch.randn(b, s, h, 128, generator=cuda, device='cuda',
                               dtype=torch.bfloat16) for _ in range(4))
    valid = torch.arange(s, device='cuda')[None] < torch.tensor(
        [[0], [900]], device='cuda')
    _, _, (dq, dk, dv) = _ring_grads(q, k, v, do, valid)
    assert not dq[0].any() and not dk[0].any()
    want = (do[0].float().sum(0) / s).expand(s, h, 128)
    assert _rel(dv[0], want) <= REL_L2


@pytest.mark.cuda
def test_accumulators_not_sent_home_break_the_bound(cuda, monkeypatch):
    q, k, v, do = (torch.randn(SHAPE, generator=cuda, device='cuda',
                               dtype=torch.bfloat16) for _ in range(4))
    out, lse, _ = _ring_grads(q, k, v, do, None)
    want = t_attn.attention_bwd_ref(q, k, v, out, do, lse)
    real = ring_mod._home

    def lost(ring, accs):
        wait = real(ring, accs)
        return lambda: [tuple(torch.zeros_like(t) for t in a) if i == 0
                        else a for i, a in enumerate(wait())]
    monkeypatch.setattr(ring_mod, '_home', lost)
    _, _, (dq, dk, dv) = _ring_grads(q, k, v, do, None)
    assert _rel(dq, want[0]) <= REL_L2
    assert _rel(dk, want[1]) > REL_L2 and _rel(dv, want[2]) > REL_L2
