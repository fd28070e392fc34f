"""Port parity for int4 serving: ``arcflow_tpu_torch.utils.quantize``,
``ops/quant_matmul.py:w4a8_matmul_ref`` and the int4 ``LoRADense`` path
against the JAX package, on the same numpy-seeded inputs.

Tolerances: packed bytes are compared exactly and scales bit for bit (the
same fp32 absmax / 7). The w4a8 products are exact integers within a scale
group, so kernel, plain version and JAX differ only in how the fp32 sum over
groups rounds (XLA may fuse each product into its add): rtol 1e-6, plus the
JAX package's own atol 1e-3 for the Pallas case, whose outputs reach 1e3.
Weight-only int4 runs fp32 dots summed in another order: rtol 1e-5, atol
1e-5 on O(1) outputs.

JAX's w4a8 mode is a process-wide flag (``set_act_quant``); each test that
sets it restores it in ``finally``, because the test runner shares a worker
process between files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from arcflow_tpu.models import layers as jlayers
from arcflow_tpu.ops.quant_matmul import w4a8_matmul_pallas
from arcflow_tpu.utils import quantize as jq
from arcflow_tpu_torch.models import layers as tlayers
from arcflow_tpu_torch.ops import quant_matmul as tqmm
from arcflow_tpu_torch.utils import quantize as tq

torch.set_num_threads(1)


def _np(x):
    return np.array(jax.device_get(x))        # a writable copy


@pytest.mark.parametrize('shape,group', [((256, 48), 64), ((3, 128, 16), 32),
                                         ((128, 8), 128)])
def test_pack_unpack_bytes_match_jax(shape, group):
    q = np.random.default_rng(0).integers(-8, 8, shape).astype(np.int8)
    q.reshape(-1)[:4] = [-8, 7, 0, -1]
    want = _np(jq.pack_int4(jnp.asarray(q), group))
    got = tq.pack_int4(torch.from_numpy(q), group)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.is_contiguous()
    q_t = torch.from_numpy(np.swapaxes(q, -1, -2).copy()).transpose(-1, -2)
    strided = tq.pack_int4(q_t, group)
    assert strided.is_contiguous() and torch.equal(strided, got)
    back = tq.unpack_int4(got, group)
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(
        back.numpy(), _np(jq.unpack_int4(jnp.asarray(want), group)))


class _Net(nn.Module):
    """LoRADense layers named to hit every skip rule of the JAX package."""

    def __init__(self):
        super().__init__()
        self.big = tlayers.LoRADense(128, 96)                # quantized
        self.adapted = tlayers.LoRADense(256, 64, lora_rank=4)  # quantized
        self.small = tlayers.LoRADense(64, 8)                # under min_size
        self.ragged = tlayers.LoRADense(80, 128)             # 80 % 32 != 0
        self.proj_out_means = tlayers.LoRADense(128, 64)     # adapter head
        self.norm_out = nn.Module()
        self.norm_out.modulation = tlayers.LoRADense(128, 64)  # final AdaLN


def _jax_tree(net):
    """The same weights as a JAX param tree, kernels (in, out)."""
    tree = {}
    for name, layer in net.named_modules():
        if isinstance(layer, tlayers.LoRADense):
            node = tree
            for part in name.split('.'):
                node = node.setdefault(part, {})
            node['kernel'] = layer.weight.detach().t().numpy().copy()
            node['bias'] = layer.bias.detach().numpy().copy()
            if layer.lora_rank:
                node['lora_a'] = layer.lora_a.detach().numpy().copy()
                node['lora_b'] = layer.lora_b.detach().numpy().copy()
    return tree


def test_quantize_weights_int4_matches_jax():
    torch.manual_seed(0)
    net = _Net()
    tree = _jax_tree(net)
    qp, quant = jq.quantize_weights_int4(tree, min_size=1024, group_size=32)
    done = tq.quantize_weights_int4(net, min_size=1024, group_size=32)
    assert sorted(done) == ['adapted', 'big']
    jflat = _flat(quant)
    assert sorted(jflat) == ['adapted.kernel_packed4', 'adapted.kernel_scale4',
                             'big.kernel_packed4', 'big.kernel_scale4']
    state = net.state_dict()
    for key, want in jflat.items():
        assert state[key].dtype == (torch.int8 if 'packed' in key
                                    else torch.float32)
        # the kernel reads the buffers as they lie (from a transposed weight)
        assert state[key].is_contiguous(), key
        np.testing.assert_array_equal(state[key].numpy(), want)
    assert 'big.weight' not in state and 'adapted.lora_a' in state
    assert 'kernel' not in qp['big'] and 'kernel' in qp['small']
    # dequantization matches too, and stays within half a step of the input
    deq_j = _flat(jq.dequantize_weights(qp, quant))
    deq_t = tq.dequantize_weights(state)
    for name in ('big', 'adapted'):
        np.testing.assert_array_equal(deq_t[f'{name}.weight'].numpy(),
                                      deq_j[f'{name}.kernel'].T)
        w = tree[name]['kernel']
        step = np.abs(w).reshape(-1, 32, w.shape[1]).max(1) / 7
        err = np.abs(deq_j[f'{name}.kernel'] - w).reshape(-1, 32, w.shape[1])
        assert (err <= step[:, None] / 2 + 1e-7).all()


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = _np(v)
    return out


def _w4a8_case():
    """The JAX package's Pallas parity case (tests/test_quantize.py):
    M 512, K 256, N 512, group 64, weights over [-8, 7]."""
    m, k, n, group = 512, 256, 512, 64
    ks = jax.random.split(jax.random.PRNGKey(6), 2)
    xq = jax.random.randint(ks[0], (m, k), -127, 128, jnp.int8)
    q = jax.random.randint(ks[1], (k, n), -8, 8, jnp.int8)
    scale = (0.01 + 0.05 * jax.random.uniform(
        jax.random.PRNGKey(7), (k // group, n))).astype(jnp.float32)
    return xq, jq.pack_int4(q, group), scale


def test_w4a8_ref_matches_pallas_interpret():
    xq, packed, scale = _w4a8_case()
    want = _np(w4a8_matmul_pallas(xq, packed, scale, block_m=512,
                                  block_n=512, k_groups=2, interpret=True))
    args = [torch.from_numpy(_np(a)) for a in (xq, packed, scale)]
    got = tqmm.w4a8_matmul_ref(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)
    before = tqmm.LAUNCHES
    np.testing.assert_array_equal(tqmm.w4a8_matmul(*args).numpy(),
                                  got.numpy())
    assert tqmm.LAUNCHES == before          # a CPU tensor launches nothing


def test_w4a8_ref_with_row_scale_matches_pallas_interpret():
    """The fused form, ``w4a8_matmul_ref(..., row_scale=xs,
    out_dtype=bf16)``, against the JAX package's two steps, ``(Pallas
    interpret * xs).astype(bf16)``. The fp32 products agree to rtol 1e-6
    (above), so after the one rounding to bf16 the two differ by at most
    one bf16 ulp where a value lies near a rounding boundary, and one ulp
    is at most 2^-7 of |value|: rtol 2^-7. The CPU wrapper takes the plain
    version, bit for bit."""
    xq, packed, scale = _w4a8_case()
    xs = (0.001 + 0.01 * jax.random.uniform(jax.random.PRNGKey(8),
                                            (xq.shape[0], 1)))
    want = _np((w4a8_matmul_pallas(xq, packed, scale, block_m=512,
                                   block_n=512, k_groups=2, interpret=True)
                * xs).astype(jnp.bfloat16).astype(jnp.float32))
    args = [torch.from_numpy(_np(a)) for a in (xq, packed, scale)]
    row_scale = torch.from_numpy(_np(xs))
    got = tqmm.w4a8_matmul_ref(*args, row_scale=row_scale,
                               out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (512, 512)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=0)
    before = tqmm.LAUNCHES
    assert torch.equal(tqmm.w4a8_matmul(*args, row_scale=row_scale,
                                        out_dtype=torch.bfloat16), got)
    assert tqmm.LAUNCHES == before
    assert torch.equal(got, (tqmm.w4a8_matmul_ref(*args) * row_scale).to(
        torch.bfloat16))


def test_w4a8_ref_is_exact_on_integer_inputs():
    """Scale 1 and small integers: the plain version is the exact integer
    product, nibble value -8 included."""
    rng = np.random.default_rng(2)
    q = rng.integers(-8, 8, (64, 24)).astype(np.int8)
    q[:, 0] = -8
    x = rng.integers(-127, 128, (3, 64)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(q), 32)
    got = tqmm.w4a8_matmul_ref(torch.from_numpy(x), packed,
                               torch.ones(2, 24))
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ q.astype(np.int64))


def test_w4a8_wrapper_rejects_other_devices():
    xq, packed, scale = (torch.zeros(2, 64, dtype=torch.int8, device='meta'),
                         torch.zeros(32, 8, dtype=torch.int8, device='meta'),
                         torch.ones(2, 8, device='meta'))
    with pytest.raises(ValueError, match='no w4a8 kernel'):
        tqmm.w4a8_matmul(xq, packed, scale)


def _int4_inputs(group=64, din=256, dout=48):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, din)).astype(np.float32)
    w = (0.1 * rng.standard_normal((din, dout))).astype(np.float32)
    _, quant = jq.quantize_weights_int4({'l': {'kernel': w}}, min_size=1,
                                        group_size=group)
    return x, _np(quant['l']['kernel_packed4']), \
        _np(quant['l']['kernel_scale4'])


@pytest.mark.parametrize('act_quant', [False, True])
def test_int4_matmul_matches_jax(act_quant):
    x, packed, scale = _int4_inputs()
    try:
        jq.set_act_quant(act_quant)
        want = _np(jlayers._int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                        jnp.asarray(scale), jnp.float32))
    finally:
        jq.set_act_quant(False)
    got = tlayers._int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                               torch.from_numpy(scale), torch.float32,
                               act_quant)
    assert got.shape == want.shape == (2, 5, 48)
    tol = dict(rtol=1e-6, atol=1e-6) if act_quant else dict(rtol=1e-5,
                                                            atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize('act_quant', [False, True])
def test_int4_lora_dense_matches_jax(act_quant):
    """The whole quantized layer: int4 product, then bias, then the LoRA
    branch, from the same float weights quantized on each side."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    params = {'kernel': (0.1 * rng.standard_normal((128, 64))).astype(
                  np.float32),
              'bias': rng.standard_normal(64).astype(np.float32),
              'lora_a': rng.standard_normal((128, 4)).astype(np.float32),
              'lora_b': rng.standard_normal((4, 64)).astype(np.float32)}
    qp, quant = jq.quantize_weights_int4({'l': params}, min_size=1,
                                         group_size=32)
    jm = jlayers.LoRADense(64, lora_rank=4, dtype=jnp.float32)
    try:
        jq.set_act_quant(act_quant)
        want = _np(jax.jit(lambda v, a: jm.apply(v, a))(
            {'params': qp['l'], 'quant': quant['l']}, jnp.asarray(x)))
    finally:
        jq.set_act_quant(False)
    tm = tlayers.LoRADense(128, 64, lora_rank=4)
    tm.load_state_dict({'weight': torch.from_numpy(params['kernel'].T.copy()),
                        **{k: torch.from_numpy(v) for k, v in params.items()
                           if k != 'kernel'}})
    tq.quantize_weights_int4(tm, min_size=1, group_size=32,
                             act_quant=act_quant)
    assert tm.is_int4 and tm.act_quant == act_quant
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
