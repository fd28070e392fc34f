"""Port parity for int8 and w8a8 serving: ``utils/quantize.py:
quantize_weights_int8``, the int8 ``LoRADense`` path, ``ops/int8_matmul.py``,
``pipelines/convert.py`` on a quantized tree and ``quantize_int8`` on the
FLUX and Qwen pipelines, against the JAX package on the same numpy-seeded
inputs.

Tolerances: int8 bytes and scales bit for bit (the same fp32 absmax / 127,
round half to even). One layer in fp32: rtol 1e-5, atol 1e-5 (weight-only:
fp32 dots summed in another order; w8a8: the integer product is exact on
both sides and the rescale is the same fp32 arithmetic). The 2-NFE
latents: weight-only int8 rtol 2e-4, atol 5e-5 as for the float pipeline
(tests/test_torch_pipeline.py); w8a8 relative L2 1e-3 as for w4a8
(tests/test_torch_qwen_pipeline.py), since an activation one fp32 ulp apart
may round to a neighbouring int8 step on the other side.

JAX's w8a8 mode is a process-wide flag (``set_act_quant``, which its
``quantize_int8`` sets); each test that sets it restores it in ``finally``,
because the test runner shares a worker process between files.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
from arcflow_tpu.models import layers as jlayers
from arcflow_tpu.pipelines import arcflux_pipeline as jpipe
from arcflow_tpu.utils import quantize as jq
from arcflow_tpu_torch.models import ArcFluxTransformer2DModel as TArcFlux
from arcflow_tpu_torch.models import ArcQwenImageTransformer2DModel as TArcQwen
from arcflow_tpu_torch.models import layers as tlayers
from arcflow_tpu_torch.ops import int8_matmul as ti8
from arcflow_tpu_torch.pipelines import (ArcFluxPipeline,
                                         ArcQwenImagePipeline,
                                         jax_params_to_torch)
from arcflow_tpu_torch.utils import quantize as tq

torch.set_num_threads(1)

FLUX_CFG = dict(in_channels=16, num_layers=2, num_single_layers=2,
                attention_head_dim=16, num_attention_heads=2,
                joint_attention_dim=24, pooled_projection_dim=16,
                axes_dims_rope=(4, 6, 6), num_gaussians=4)
QWEN_CFG = dict(in_channels=16, num_layers=2, attention_head_dim=32,
                num_attention_heads=2, joint_attention_dim=64,
                axes_dims_rope=(8, 12, 12), max_text_len=6, num_gaussians=4,
                lora_rank=4)
FAMILIES = {
    'flux': (JArcFlux, dict(guidance_embeds=True), TArcFlux, ArcFluxPipeline,
             jpipe.ArcFluxPipeline, FLUX_CFG,
             dict(shift=3.2, nfe=2, temperature=0.7, guidance_scale=3.5)),
    'qwen': (JArcQwen, {}, TArcQwen, ArcQwenImagePipeline,
             jpipe.ArcQwenImagePipeline, QWEN_CFG,
             dict(shift=3.1, nfe=2, temperature=0.7))}
# every block kernel of the tiny models is at least this large, so the JAX
# rule (a scanned stack's size) and the port's (one layer's) agree
MIN_SIZE = 1024
W8A8_REL_L2 = 1e-3


def _np(x):
    return np.array(jax.device_get(x))        # a writable copy


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


def _inputs(family, rng):
    f = np.float32
    latents = rng.standard_normal((2, 8, 8, 4)).astype(f)
    if family == 'flux':
        embeds = dict(encoder_hidden_states=rng.standard_normal(
            (2, 5, 24)).astype(f), pooled_projections=rng.standard_normal(
            (2, 16)).astype(f))
    else:
        mask = np.ones((2, 8), np.int32)
        mask[0, 3:] = 0
        embeds = dict(encoder_hidden_states=rng.standard_normal(
            (2, 8, 64)).astype(f), encoder_hidden_states_mask=mask)
    return latents, embeds


@pytest.fixture(scope='module', params=list(FAMILIES))
def pair(request):
    """A tiny JAX model with jittered params and the JAX pipeline's float
    latents, and a factory for the port's pipeline on the same weights."""
    family = request.param
    jcls, j_only, tcls, tpipe_cls, jpipe_cls, cfg, pipe_cfg = \
        FAMILIES[family]
    rng = np.random.default_rng(11)
    latents, embeds = _inputs(family, rng)
    jm = jcls(patch_size=2, checkpointing=False, dtype=jnp.float32,
              **j_only, **cfg)
    extra = dict(guidance=jnp.ones((2,))) if family == 'flux' else {}
    params = _jitter(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(latents), t=jnp.ones((2,)),
        **extra, **{k: jnp.asarray(v) for k, v in embeds.items()}
    )['params'])
    j_embeds = {k: jnp.asarray(v) for k, v in embeds.items()}
    t_embeds = {k: torch.from_numpy(v) for k, v in embeds.items()}

    def port_pipe():
        model = tcls(dtype=torch.float32, **cfg)
        model.load_state_dict(jax_params_to_torch(params), strict=True)
        return tpipe_cls(model, **pipe_cfg)

    def j_latents(act_quant=None):
        jp = jpipe_cls(jm, params, **pipe_cfg)
        try:
            if act_quant is not None:
                jp.quantize_int8(act_quant=act_quant, min_size=MIN_SIZE)
            return _np(jp(prompt_embeds=j_embeds,
                          latents=jnp.asarray(latents),
                          output_type='latent')['latents'])
        finally:
            jq.set_act_quant(False)

    def t_latents(pipe):
        return pipe(prompt_embeds=t_embeds, latents=torch.from_numpy(latents),
                    output_type='latent')['latents'].numpy()

    return SimpleNamespace(family=family, params=params, port_pipe=port_pipe,
                           j_latents=j_latents, t_latents=t_latents,
                           noise=latents)


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = _np(v)
    return out


def test_quantized_bytes_scales_and_names_match_jax(pair):
    qp, quant = jq.quantize_weights_int8(pair.params, min_size=MIN_SIZE)
    want = jax_params_to_torch(qp, quant)
    pipe = pair.port_pipe()
    done = tq.quantize_weights_int8(pipe.transformer, min_size=MIN_SIZE)
    want_names = sorted(k[:-len('.kernel')] for k, v in want.items()
                        if k.endswith('.kernel'))
    assert sorted(done) == want_names and len(done) > 10
    state = pipe.transformer.state_dict()
    for name in done:
        kernel, scale = state[f'{name}.kernel'], state[f'{name}.kernel_scale']
        assert kernel.dtype == torch.int8 and scale.dtype == torch.float32
        # column-major: the bytes of (out, in), as the GEMM reads them
        assert kernel.t().is_contiguous(), name
        assert torch.equal(kernel, want[f'{name}.kernel']), name
        assert torch.equal(scale, want[f'{name}.kernel_scale']), name
        assert f'{name}.weight' not in state
    # dequantization matches the JAX package's too
    deq_j = jax_params_to_torch(jq.dequantize_weights(qp, quant))
    deq_t = tq.dequantize_weights(state)
    for name in done:
        assert torch.equal(deq_t[f'{name}.weight'], deq_j[f'{name}.weight'])


def test_jax_quantized_tree_loads_strictly(pair):
    """A JAX ``quantize_weights_int8`` tree carries over with
    ``strict=True`` into a quantized port model, int8 kernels as int8 (not
    cast to a float ``weight``), and computes what the port's own
    quantization computes."""
    qp, quant = jq.quantize_weights_int8(pair.params, min_size=MIN_SIZE)
    converted = jax_params_to_torch(qp, quant)
    own = pair.port_pipe()
    own.quantize_int8(act_quant=True, min_size=MIN_SIZE)
    loaded = pair.port_pipe()
    with torch.no_grad():                    # other weights, then the tree
        for p in loaded.transformer.parameters():
            p.add_(1.0)
    loaded.quantize_int8(act_quant=True, min_size=MIN_SIZE)
    loaded.transformer.load_state_dict(converted, strict=True)
    state = loaded.transformer.state_dict()
    for key, v in converted.items():
        if key.endswith('.kernel'):
            assert state[key].dtype == torch.int8 and torch.equal(state[key], v)
            assert state[key].t().is_contiguous()
    np.testing.assert_array_equal(pair.t_latents(loaded), pair.t_latents(own))


@pytest.mark.parametrize('act_quant', [False, True])
def test_quantize_int8_pipeline_matches_jax(pair, act_quant):
    want = pair.j_latents(act_quant)
    pipe = pair.port_pipe()
    float_lat = pair.t_latents(pipe)
    n = pipe.quantize_int8(act_quant=act_quant, min_size=MIN_SIZE)
    qp, quant = jq.quantize_weights_int8(pair.params, min_size=MIN_SIZE)
    assert n == sum(k.endswith('.kernel_scale')
                    for k in jax_params_to_torch(qp, quant))
    assert all(m.act_quant == act_quant for m in pipe.transformer.modules()
               if isinstance(m, tlayers.LoRADense) and m.is_int8)
    got = pair.t_latents(pipe)
    assert got.shape == want.shape == pair.noise.shape
    assert np.abs(got - pair.noise).max() > 0.1    # the sampler moved x
    assert np.abs(got - float_lat).max() > 1e-4    # quantization shows
    if act_quant:
        assert np.linalg.norm(got - want) <= W8A8_REL_L2 * np.linalg.norm(
            want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)
    with pytest.raises(ValueError, match='already quantized'):
        pipe.quantize_int8()
    with pytest.raises(ValueError, match='already quantized'):
        pipe.quantize_int4()


def _layer_params(rng, din=128, dout=64):
    return {'kernel': (0.1 * rng.standard_normal((din, dout))).astype(
                np.float32),
            'bias': rng.standard_normal(dout).astype(np.float32),
            'lora_a': rng.standard_normal((din, 4)).astype(np.float32),
            'lora_b': rng.standard_normal((4, dout)).astype(np.float32)}


@pytest.mark.parametrize('act_quant', [False, True])
@pytest.mark.parametrize('lead', [(3,), (1,), (2, 5)])
def test_int8_lora_dense_matches_jax(act_quant, lead):
    """The whole quantized layer (int8 product, bias, LoRA branch) from the
    same float weights quantized on each side; one row (M = 1, as the
    modulations run at batch 1) included."""
    rng = np.random.default_rng(9)
    params = _layer_params(rng)
    x = rng.standard_normal((*lead, 128)).astype(np.float32)
    qp, quant = jq.quantize_weights_int8({'l': params}, min_size=1)
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
    assert tq.quantize_weights_int8(tm, min_size=1,
                                    act_quant=act_quant) == ['']
    assert tm.is_int8 and tm.act_quant == act_quant and not tm.is_int4
    before = ti8.LAUNCHES
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert ti8.LAUNCHES == before             # a CPU tensor launches nothing
    assert got.shape == (*lead, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_skip_rules_match_jax():
    """The adapter surface and small kernels stay float; int8 has no group
    rule, so odd input widths quantize."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.big = tlayers.LoRADense(128, 96)
            self.odd = tlayers.LoRADense(77, 64)
            self.small = tlayers.LoRADense(64, 8)
            self.proj_out_means = tlayers.LoRADense(128, 64)
            self.norm_out = torch.nn.Module()
            self.norm_out.modulation = tlayers.LoRADense(128, 64)
    net = Net()
    tree = {name: {'kernel': layer.weight.detach().t().numpy().copy()}
            for name, layer in (('big', net.big), ('odd', net.odd),
                                ('small', net.small),
                                ('proj_out_means', net.proj_out_means))}
    tree['norm_out'] = {'modulation': {
        'kernel': net.norm_out.modulation.weight.detach().t().numpy()}}
    _, quant = jq.quantize_weights_int8(tree, min_size=1024)
    assert sorted(quant) == ['big', 'odd']
    assert sorted(tq.quantize_weights_int8(net, min_size=1024)) == \
        ['big', 'odd']
    assert tq.quantize_weights_int8(net, min_size=1024) == []   # done once


def test_int8_matmul_ref_is_exact():
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, (5, 12288)).astype(np.int8)
    w = rng.integers(-127, 128, (12288, 16)).astype(np.int8)
    x[0], w[:, 0] = -127, -127                 # the largest sums
    got = ti8.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize('xq,w,match', [
    (torch.zeros(4, 64), torch.zeros(64, 8, dtype=torch.int8), 'int8'),
    (torch.zeros(4, 64, dtype=torch.int8),
     torch.zeros(32, 8, dtype=torch.int8), 'inner sizes'),
    (torch.zeros(4, 60, dtype=torch.int8),
     torch.zeros(60, 8, dtype=torch.int8), 'multiples of 8'),
    (torch.zeros(4, 64, dtype=torch.int8),
     torch.zeros(64, 12, dtype=torch.int8), 'multiples of 8'),
    (torch.zeros(64, dtype=torch.int8), torch.zeros(64, 8, dtype=torch.int8),
     'takes xq'),
])
def test_int8_matmul_argument_checks(xq, w, match):
    """What the library call does not take is refused (metadata only, so
    the checks run here)."""
    with pytest.raises(ValueError, match=match):
        ti8._check_cuda_args(xq, w)


def test_int8_matmul_rejects_other_devices():
    x = torch.zeros(2, 64, dtype=torch.int8, device='meta')
    with pytest.raises(ValueError, match='no int8 product'):
        ti8.int8_matmul(x, torch.zeros(64, 8, dtype=torch.int8,
                                       device='meta'))
