"""Port parity for ring attention: ``ops/ring_hop.py`` (K4's plain version
and its CPU wrapper) and ``parallel/ring_attention.py`` in one process
(``LocalRing``) against the JAX package's ring on the simulated 8-device
CPU mesh, in both JAX tiers: the plain ``use_flash=False`` tier and the
flash tier with its hop routed through ``_hop_stats_ref`` (the mirror of
the Pallas hop's residual contract; interpret-mode Pallas cannot run inside
a multi-device ``shard_map``, as ``tests/test_ring_attention.py`` notes).

All in fp32 on the same numpy inputs. Tolerances: rtol 2e-5, atol 2e-6 on
outputs, those of ``tests/test_ring_attention.py`` for the ring against
full attention (sums in another order); the carry rtol 1e-5, atol 1e-5 (the
same sums, over fewer keys).
"""

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.parallel import make_mesh
from arcflow_tpu.parallel import ring_attention as j_ring_attention
from arcflow_tpu_torch.models import ArcFluxTransformer2DModel as TArcFlux
from arcflow_tpu_torch.models import layers as t_layers
from arcflow_tpu_torch.ops import ring_hop as t_hop
from arcflow_tpu_torch.parallel import (LocalRing, ring_attention,
                                        ring_partition,
                                        set_sequence_parallel)
from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)

ra = importlib.import_module('arcflow_tpu.parallel.ring_attention')
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
CARRY_TOL = dict(rtol=1e-5, atol=1e-5)
# the rest of the 8 simulated devices goes to a 'data' axis the batch does
# not use, as in tests/test_ring_attention.py
MESHES = {2: {'data': 4, 'sp': 2}, 4: {'data': 2, 'sp': 4}, 8: {'sp': 8}}


def _qkv(seed, b=2, s=512, h=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _valid(lengths, s):
    return np.arange(s)[None, :] < np.asarray(lengths)[:, None]


def _jax_ring(q, k, v, valid, size, use_flash):
    mesh = make_mesh(MESHES[size])
    out = j_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           mesh, 'sp',
                           kv_valid=None if valid is None
                           else jnp.asarray(valid),
                           use_flash=use_flash)
    return np.asarray(out)


def _port_ring(q, k, v, valid, size):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    mask = None if valid is None else torch.from_numpy(valid)
    return ring_attention(*t, mask, LocalRing(size)).numpy()


@pytest.fixture
def jax_tier(request, monkeypatch):
    """'plain': the JAX ``use_flash=False`` tier; 'flash': the flash tier
    with its hop through ``_hop_stats_ref``."""
    if request.param == 'flash':
        monkeypatch.setattr(ra, '_hop_stats', ra._hop_stats_ref)
    return request.param == 'flash'


def _jax_fold(qt, blocks, scale):
    """``_ring_flash_core``'s hop loop (ring_attention.py:181-190) over the
    given blocks, without the rotation: the JAX carry after each hop."""
    b, h, sq, d = qt.shape
    acc = jnp.zeros((b, h, sq, d), jnp.float32)
    m_acc = jnp.full((b, h, sq), ra._NEG_INF, jnp.float32)
    l_acc = jnp.zeros((b, h, sq), jnp.float32)
    q_ids = jnp.zeros((b, sq), jnp.int32)
    carries = []
    for kt, vt, valid in blocks:
        ids = None if valid is None else \
            jnp.where(jnp.asarray(valid), 0, 1).astype(jnp.int32)
        o_i, l_i, m_i = ra._hop_stats_ref(qt, kt, vt, q_ids, ids, scale)
        m_new = jnp.maximum(m_acc, m_i)
        c1 = l_acc * jnp.exp(m_acc - m_new)
        c2 = l_i * jnp.exp(m_i - m_new)
        acc = acc * jnp.exp(m_acc - m_new)[..., None] + o_i * c2[..., None]
        m_acc, l_acc = m_new, c1 + c2
        carries.append(tuple(np.asarray(x) for x in (acc, m_acc, l_acc)))
    return carries


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('hops', [1, 2, 3, 4])
def test_ring_hop_ref_carry_matches_jax_fold(hops, masked):
    """The carry after each of 1-4 hops, and O after the last, against JAX
    ``_hop_stats_ref`` plus the fp32 fold of ``_ring_flash_core``. Masked:
    row 0's first block is fully padded, so its carry after that hop is
    (0, -inf, 0) in the port and (0, -1e30, 0) in JAX."""
    b, sq, skv, h, d = 2, 24, 20, 3, 16
    rng = np.random.default_rng(hops)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    blocks = []
    for i in range(hops):
        k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32)
                for _ in range(2))
        valid = None
        if masked:
            valid = _valid([0 if i == 0 else 13, skv - 3 * i], skv)
        blocks.append((k, v, valid))

    want = _jax_fold(jnp.asarray(q.transpose(0, 2, 1, 3)),
                     [(jnp.asarray(k.transpose(0, 2, 1, 3)),
                       jnp.asarray(v.transpose(0, 2, 1, 3)), valid)
                      for k, v, valid in blocks], 1.0 / np.sqrt(d))
    carry = None
    for i, (k, v, valid) in enumerate(blocks):
        last = i == hops - 1
        carry, out = t_hop.ring_hop_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            None if valid is None else torch.from_numpy(valid), carry, last)
        acc, m, l = (x.numpy() for x in carry)
        w_acc, w_m, w_l = want[i]
        np.testing.assert_allclose(acc.transpose(0, 2, 1, 3), w_acc,
                                   **CARRY_TOL)
        np.testing.assert_allclose(l, w_l, **CARRY_TOL)
        seen = w_l > 0
        np.testing.assert_allclose(m[seen], w_m[seen], **CARRY_TOL)
        assert np.all(np.isneginf(m[~seen]))
        assert (out is not None) == last
    w_out = w_acc / np.maximum(w_l, 1e-30)[..., None]       # JAX line 203
    np.testing.assert_allclose(out.numpy(), w_out.transpose(0, 2, 1, 3),
                               **CARRY_TOL)


def test_ring_hop_wrapper_takes_the_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, s=40))
    valid = torch.from_numpy(_valid([30, 40], 40))
    before = t_hop.LAUNCHES
    (acc, m, l), out = t_hop.ring_hop(q, k, v, valid, None, last=True)
    (acc_r, m_r, l_r), out_r = t_hop.ring_hop_ref(q, k, v, valid, None, True)
    assert t_hop.LAUNCHES == before
    for x, y in ((acc, acc_r), (m, m_r), (l, l_r), (out, out_r)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match='no ring hop kernel'):
        t_hop.ring_hop(q.to('meta'), k.to('meta'), v.to('meta'))


@pytest.mark.parametrize('jax_tier', ['plain', 'flash'], indirect=True)
@pytest.mark.parametrize('lengths', [None, (200, 383)],
                         ids=['unmasked', 'padded'])
@pytest.mark.parametrize('size', [2, 4, 8])
def test_local_ring_matches_jax_ring(size, lengths, jax_tier):
    """S = 512; lengths 200 and 383 leave row 0's last shards fully padded
    (for sp = 2, 4 and 8), the hop whose contribution must vanish."""
    q, k, v = _qkv(size)
    valid = None if lengths is None else _valid(lengths, 512)
    want = _jax_ring(q, k, v, valid, size, jax_tier)
    np.testing.assert_allclose(_port_ring(q, k, v, valid, size), want,
                               **OUT_TOL)


@pytest.mark.parametrize('jax_tier', ['plain', 'flash'], indirect=True)
def test_local_ring_three_heads_sp4(jax_tier):
    """3 heads over sp = 4: the ring does not need heads % sp == 0."""
    q, k, v = _qkv(11, s=64, h=3)
    valid = _valid([40, 64], 64)
    want = _jax_ring(q, k, v, valid, 4, jax_tier)
    np.testing.assert_allclose(_port_ring(q, k, v, valid, 4), want,
                               **OUT_TOL)


def test_keyless_row_gets_the_mean_of_v(monkeypatch):
    """A batch row with no valid key on any shard: the port's ring gives the
    mean of v over all S keys, as its single-device ``layers.attention`` and
    the JAX plain tier do. The JAX flash tier (the one that runs the TPU
    hop) gives 0 there (ring_attention.py:183-190, 203): a divergence inside
    the JAX package that the port does not copy."""
    q, k, v = _qkv(5, s=64)
    valid = _valid([0, 50], 64)
    got = _port_ring(q, k, v, valid, 4)
    one_device = t_layers.attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        mask=torch.from_numpy(valid)[:, None, None, :]).numpy()
    np.testing.assert_allclose(got, one_device, **OUT_TOL)
    mean_v = np.broadcast_to(v[0].mean(axis=0), got[0].shape)
    np.testing.assert_allclose(got[0], mean_v, **OUT_TOL)
    np.testing.assert_allclose(got, _jax_ring(q, k, v, valid, 4, False),
                               **OUT_TOL)
    monkeypatch.setattr(ra, '_hop_stats', ra._hop_stats_ref)
    flash = _jax_ring(q, k, v, valid, 4, True)
    assert np.all(flash[0] == 0.0)
    np.testing.assert_allclose(got[1], flash[1], **OUT_TOL)


def test_ring_partition_guards():
    assert ring_partition((2, 24, 4, 16), 4) == 6
    assert ring_partition((2, 24, 3, 16), 4) == 6     # heads need not divide
    with pytest.raises(ValueError, match='S % sp'):
        ring_partition((2, 23, 4, 16), 4)
    with pytest.raises(ValueError, match='at least one shard'):
        LocalRing(0)
    q = torch.zeros(1, 23, 2, 16)
    with pytest.raises(ValueError, match='S % sp'):
        ring_attention(q, q, q, None, LocalRing(4))


@pytest.mark.parametrize('axis', ['tensor', 'pipe', 'expert'])
def test_waiting_axes_beside_sp_are_refused_by_name(axis):
    """The ring trains now (``tests/test_torch_sp_train.py``); the
    compositions with ``sp`` that wait for their slices are refused by
    name: ``pipe`` and ``expert``, which train beside ``data``, beside
    ``sp`` (item 5.8), and ``tensor`` beside ``sp`` in a training mesh
    (item 5.11). ``sp x tensor`` serves (``tests/test_torch_tensor_
    parallel.py``): in one process it meets JAX's device count."""
    from arcflow_tpu_torch.parallel import make_mesh
    item = '5.11' if axis == 'tensor' else '5.8'
    if axis == 'tensor':
        with pytest.raises(ValueError, match='!= 1 devices'):
            make_mesh({'sp': 1, axis: 2})
    else:
        with pytest.raises(NotImplementedError,
                           match=f"'{axis}'.*queue A item {item}"):
            make_mesh({'sp': 1, axis: 2})
    with pytest.raises(NotImplementedError,
                       match=f"'{axis}'.*queue A item {item}"):
        make_mesh({'data': 1, 'fsdp': 1, 'sp': 2, axis: 2})


def _local_ring_model_case(family, size, n_txt):
    """The tiny model of ``family`` with every attention on
    ``LocalRing(size)`` and ``n_txt`` text tokens (Qwen's first sample
    masks all but 3) against the unsharded JAX forward, at the JAX ring
    test's tolerance (rtol 2e-3, atol 2e-4)."""
    from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
    from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
    from arcflow_tpu_torch.models import \
        ArcQwenImageTransformer2DModel as TArcQwen
    cfg = dict(in_channels=16, num_layers=2, attention_head_dim=16,
               num_attention_heads=4, joint_attention_dim=32,
               axes_dims_rope=(4, 6, 6), num_gaussians=4)
    rng = np.random.default_rng(5)
    inputs = dict(
        hidden_states=rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
        t=np.full((2,), 0.7, np.float32),
        encoder_hidden_states=rng.standard_normal((2, n_txt, 32)).astype(
            np.float32))
    if family == 'flux':
        cfg.update(num_single_layers=2, pooled_projection_dim=16)
        inputs.update(
            pooled_projections=rng.standard_normal((2, 16)).astype(
                np.float32), guidance=np.full((2,), 3.5, np.float32))
        jm = JArcFlux(guidance_embeds=True, patch_size=2,
                      checkpointing=False, dtype=jnp.float32, **cfg)
        tm = TArcFlux(dtype=torch.float32, **cfg)
    else:
        cfg.update(max_text_len=16, lora_rank=4)
        mask = np.ones((2, n_txt), np.int32)
        mask[0, 3:] = 0
        inputs.update(encoder_hidden_states_mask=mask)
        jm = JArcQwen(patch_size=2, checkpointing=False, dtype=jnp.float32,
                      **cfg)
        tm = TArcQwen(dtype=torch.float32, **cfg)
    j_in = {n: jnp.asarray(x) for n, x in inputs.items()}
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32),
        jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        **j_in)['params']))
    want = jax.jit(jm.apply)({'params': params}, **j_in)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    set_sequence_parallel(tm, LocalRing(size))
    before = t_hop.LAUNCHES
    calls = []

    def spy(q, k, v, kv_valid, ring, **kw):
        calls.append(kv_valid)
        return ring_attention(q, k, v, kv_valid, ring, **kw)
    with torch.no_grad(), mock.patch.object(t_layers, 'ring_attention', spy):
        got = tm(**{n: torch.from_numpy(x) for n, x in inputs.items()})
    assert t_hop.LAUNCHES == before         # CPU: the plain version
    for key in ('means', 'logweights', 'loggammas'):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-3, atol=2e-4, err_msg=key)
    return calls


def test_arcflux_under_local_ring_matches_jax():
    """The tiny ArcFlux of tests/test_ring_attention.py (guidance embeds on,
    as the port's FLUX always has them) with every attention on
    ``LocalRing(4)`` against the unsharded JAX forward; 8 text and 16 image
    tokens split evenly, so nothing is padded and no attention is
    masked."""
    calls = _local_ring_model_case('flux', 4, 8)
    assert calls and all(m is None for m in calls)


@pytest.mark.parametrize('family', ['flux', 'qwen'])
@pytest.mark.parametrize('size,n_txt', [(3, 8), (4, 7)])
def test_streams_that_sp_does_not_divide_match_jax(family, size, n_txt):
    """sp = 3 divides neither the 8 text nor the 16 image tokens, sp = 4
    not 7 text tokens: the trunk pads each such stream with tokens that are
    masked as keys and dropped before the heads, and the output is the
    unsharded JAX forward's."""
    calls = _local_ring_model_case(family, size, n_txt)
    n_img = 16
    padded = -n_txt % size + n_txt + -n_img % size + n_img
    assert calls and all(m is not None and m.shape == (2, padded)
                         for m in calls)
    assert all(int(m[1].sum()) == n_txt + n_img for m in calls)
