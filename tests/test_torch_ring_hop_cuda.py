"""The Hopper ring-hop kernel (K4) against its plain version, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernel has no CPU
mode). This file imports no JAX, so it runs where only the port is
installed: ``python -m pytest --noconftest -q tests/test_torch_ring_hop_cuda.py``.

Limits, bf16 kernel vs fp32 plain version, as ``chip_smoke.py`` holds K4:
on O (bf16) and on the normalized carry acc / l (fp32), every element
within 2e-3 + 2^-7 |ref| (the kernel rounds P to bf16 before P.V, and O
to bf16: one ulp is at most 2^-7 of |O|) and the whole within 1e-2 by
relative L2 (a sound kernel reads a few 1e-3); the carry's log-sum-exp
m + log l within 1e-3 (fp32 statistics of scores from bf16 products,
summed in another order). A row that has seen no valid key has l = 0 and
m = -inf in both, exactly. Planted faults (a dropped hop, a V tile read
with its key rows out of place, a lost rotation of the ring) must break
both limits.
"""

import importlib

import pytest
import torch

from arcflow_tpu_torch.ops import attention as t_attn
from arcflow_tpu_torch.ops import ring_hop as t_hop
from arcflow_tpu_torch.parallel import LocalRing, ring_attention

ATOL, RTOL, REL_L2, LSE_TOL = 2e-3, 2 ** -7, 1e-2, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _block(g, b, s, h, lengths=None):
    k, v = (torch.randn(b, s, h, 128, generator=g, device='cuda',
                        dtype=torch.bfloat16) for _ in range(2))
    valid = None
    if lengths is not None:
        valid = torch.arange(s, device='cuda')[None, :] < torch.tensor(
            lengths, device='cuda')[:, None]
    return k, v, valid


def _past_limits(got, want):
    """(whether some element lies past ATOL + RTOL |want|, relative L2)."""
    got, want = got.float(), want.float()
    over = bool(((got - want).abs() > ATOL + RTOL * want.abs()).any())
    return over, ((got - want).norm() / want.norm()).item()


def _close(got, want):
    over, rel = _past_limits(got, want)
    assert not over and rel <= REL_L2, rel


def _normalized(carry):
    acc, _, l = carry
    l_t = l.transpose(1, 2)[..., None]
    return torch.where(l_t > 0, acc / l_t, 0.0)


def _check_carry(carry, ref):
    (acc, m, l), (acc_r, m_r, l_r) = carry, ref
    seen = l_r > 0
    assert torch.equal(seen, l > 0)
    assert torch.all(torch.isneginf(m[~seen])) and torch.all(l[~seen] == 0)
    torch.testing.assert_close((m + l.log())[seen], (m_r + l_r.log())[seen],
                               rtol=0, atol=LSE_TOL)
    _close(_normalized(carry), _normalized(ref))


def _chain(q, blocks, hop):
    carry = None
    for i, (k, v, valid) in enumerate(blocks):
        carry, out = hop(q, k, v, valid, carry, last=i == len(blocks) - 1)
    return carry, out


@pytest.mark.cuda
@pytest.mark.parametrize('b,s,h,lengths', [
    (1, 1152, 24, None),                 # the FLUX hop at sp = 4
    (2, 1152, 24, (1000, 1152)),         # partly padded
    (2, 1152, 4, (0, 600)),              # a fully padded visiting block
    (2, 193, 3, (150, 193)),             # ragged: not a multiple of 64
    (1, 1, 1, None)])
def test_one_hop_matches_plain_version(cuda, b, s, h, lengths):
    q = torch.randn(b, s, h, 128, generator=cuda, device='cuda',
                    dtype=torch.bfloat16)
    blocks = [_block(cuda, b, s, h, lengths)]
    before = t_hop.LAUNCHES
    carry, out = _chain(q, blocks, t_hop.ring_hop)
    torch.cuda.synchronize()
    assert t_hop.LAUNCHES == before + 1
    ref, out_r = _chain(q, blocks, t_hop.ring_hop_ref)
    _check_carry(carry, ref)
    _close(out, out_r)


@pytest.mark.cuda
@pytest.mark.parametrize('sq,skv', [(1152, 1152), (193, 300), (300, 65)])
def test_four_hop_chain_matches_and_repeats_bitwise(cuda, sq, skv):
    """first, two middle hops and last, one block fully padded for row 0;
    a second run gives the same bits."""
    q = torch.randn(2, sq, 3, 128, generator=cuda, device='cuda',
                    dtype=torch.bfloat16)
    blocks = [_block(cuda, 2, skv, 3, lengths)
              for lengths in ((0, skv), (skv // 2, skv), (skv, 1), (3, skv))]
    before = t_hop.LAUNCHES
    carry, out = _chain(q, blocks, t_hop.ring_hop)
    again, out2 = _chain(q, blocks, t_hop.ring_hop)
    torch.cuda.synchronize()
    assert t_hop.LAUNCHES == before + 8
    ref, out_r = _chain(q, blocks, t_hop.ring_hop_ref)
    _check_carry(carry, ref)
    _close(out, out_r)
    assert torch.equal(out, out2)
    assert all(torch.equal(x, y) for x, y in zip(carry, again))


@pytest.mark.cuda
def test_kernel_reads_strided_inputs_and_uint8_masks(cuda):
    wide = torch.randn(3, 2, 300, 3, 256, generator=cuda, device='cuda',
                       dtype=torch.bfloat16)
    q, k, v = (wide[i, ..., :128] for i in range(3))
    assert not q.is_contiguous()
    valid = (torch.arange(300, device='cuda')[None, :] < torch.tensor(
        [[250], [300]], device='cuda')).to(torch.uint8)
    carry, out = t_hop.ring_hop(q, k, v, valid, None, last=True)
    ref, out_r = t_hop.ring_hop_ref(q, k, v, valid, None, last=True)
    _check_carry(carry, ref)
    _close(out, out_r)


@pytest.mark.cuda
def test_local_ring_matches_one_device_attention(cuda):
    """``ring_attention`` on ``LocalRing(4)``: 16 launches, O and the merged
    log-sum-exp against ``attention_ref``, a keyless batch row included."""
    q, k, v = (torch.randn(2, 1000, 4, 128, generator=cuda, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    valid = torch.arange(1000, device='cuda')[None, :] < torch.tensor(
        [[0], [700]], device='cuda')
    before = t_hop.LAUNCHES
    out, lse = ring_attention(q, k, v, valid, LocalRing(4), return_lse=True)
    torch.cuda.synchronize()
    assert t_hop.LAUNCHES == before + 16
    ref, ref_lse = t_attn.attention_ref(q[1:], k[1:], v[1:], valid[1:],
                                        return_lse=True)
    _close(out[1:], ref)
    torch.testing.assert_close(lse[1:], ref_lse, rtol=0, atol=LSE_TOL)
    mean_v = v[0].float().mean(dim=0).to(out.dtype).expand_as(out[0])
    torch.testing.assert_close(out[0], mean_v, rtol=0, atol=1e-2)
    assert torch.all(torch.isneginf(lse[0]))


@pytest.mark.cuda
def test_planted_faults_break_both_limits(cuda, monkeypatch):
    """A dropped hop, a V tile read with key rows 0-7 and 8-15 swapped, and
    a ring whose first rotation is lost: each moves O past both limits."""
    q = torch.randn(1, 1152, 4, 128, generator=cuda, device='cuda',
                    dtype=torch.bfloat16)
    blocks = [_block(cuda, 1, 1152, 4, lengths)
              for lengths in (None, (1000,), None)]
    _, out_r = _chain(q, blocks, t_hop.ring_hop_ref)
    k, v, valid = blocks[0]
    swap = torch.cat([torch.arange(8, 16), torch.arange(8)]).to(v.device)
    v_bad = v.clone()
    v_bad[:, :16] = v[:, swap]
    for chain in (blocks[:1] + blocks[2:], [(k, v_bad, valid)] + blocks[1:]):
        over, rel = _past_limits(_chain(q, chain, t_hop.ring_hop)[1], out_r)
        assert over and rel > REL_L2

    ring_mod = importlib.import_module(
        'arcflow_tpu_torch.parallel.ring_attention')
    real = ring_mod._rotation
    calls = []

    def lost_first(ring, blocks):
        calls.append(None)
        return (lambda: blocks) if len(calls) == 1 else real(ring, blocks)
    q, k, v = (torch.randn(1, 1000, 4, 128, generator=cuda, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    want = t_attn.attention_ref(q, k, v)
    _close(ring_attention(q, k, v, None, LocalRing(4)), want)
    monkeypatch.setattr(ring_mod, '_rotation', lost_first)
    over, rel = _past_limits(ring_attention(q, k, v, None, LocalRing(4)),
                             want)
    assert over and rel > REL_L2


def _hop_pair(g, b, sq, skv, h, lengths):
    """q (B, Sq, H, 128) and two visiting blocks of Skv keys, the second
    masked to ``lengths`` (None: unmasked)."""
    q = torch.randn(b, sq, h, 128, generator=g, device='cuda',
                    dtype=torch.bfloat16)
    return q, [_block(g, b, skv, h), _block(g, b, skv, h, lengths)]


@pytest.mark.cuda
@pytest.mark.parametrize('sq,skv', [(127, 127), (128, 128), (129, 129),
                                    (193, 193), (1152, 1152), (127, 129),
                                    (129, 193), (1152, 127)])
def test_tile_edges_match_and_repeat_bitwise(cuda, sq, skv):
    """Query and key counts on both sides of the 128-row tiles, two hops
    (the second's key mask ends inside a tile for row 0), and a second run
    bitwise equal to the first."""
    q, blocks = _hop_pair(cuda, 2, sq, skv, 3, (max(1, skv - 70), skv))
    before = t_hop.LAUNCHES
    carry, out = _chain(q, blocks, t_hop.ring_hop)
    again, out2 = _chain(q, blocks, t_hop.ring_hop)
    torch.cuda.synchronize()
    assert t_hop.LAUNCHES == before + 4
    ref, out_r = _chain(q, blocks, t_hop.ring_hop_ref)
    _check_carry(carry, ref)
    _close(out, out_r)
    assert torch.equal(out, out2)
    assert all(torch.equal(x, y) for x, y in zip(carry, again))


@pytest.mark.cuda
@pytest.mark.parametrize('b,h', [(2, 70), (1, 1)])
def test_batch_heads_past_the_card_and_one(cuda, b, h):
    """B * H = 140 (more (batch, head) slices than the 132 SMs of an H100)
    and B * H = 1."""
    q, blocks = _hop_pair(cuda, b, 129, 300, h, (200,) * b)
    carry, out = _chain(q, blocks, t_hop.ring_hop)
    torch.cuda.synchronize()
    ref, out_r = _chain(q, blocks, t_hop.ring_hop_ref)
    _check_carry(carry, ref)
    _close(out, out_r)


@pytest.mark.cuda
@pytest.mark.parametrize('first,last', [(True, False), (False, True),
                                        (True, True), (False, False)])
def test_first_and_last_alone_and_together(cuda, first, last):
    """One hop with each combination of the flags: ``first`` starts the
    carry instead of reading it, ``last`` also writes O (None otherwise);
    the carry read is the plain version's, and two runs from the same carry
    give the same bits. The key mask ends inside the second tile."""
    q, blocks = _hop_pair(cuda, 2, 193, 300, 3, (200, 300))
    start = None
    if not first:
        (acc, m, l), _ = t_hop.ring_hop_ref(q, *blocks[0])
        start = tuple(x.contiguous() for x in (acc, m, l))
    k, v, valid = blocks[1]

    def run():
        carry = None if start is None else tuple(x.clone() for x in start)
        return t_hop.ring_hop(q, k, v, valid, carry, last=last)
    carry, out = run()
    again, out2 = run()
    torch.cuda.synchronize()
    ref, out_r = t_hop.ring_hop_ref(q, k, v, valid, start, last=last)
    _check_carry(carry, ref)
    assert all(torch.equal(x, y) for x, y in zip(carry, again))
    if last:
        _close(out, out_r)
        assert torch.equal(out, out2)
    else:
        assert out is None and out2 is None
