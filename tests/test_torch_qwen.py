"""Port parity: ArcQwenImageTransformer2DModel (arcflow_tpu_torch.models.qwen)
against the JAX model, in float and int4-quantized (w4a8 and weight-only).

A tiny ArcQwen (2 joint blocks, 2 heads x 32, joint dim 64, K=4, LoRA rank
4, ``max_text_len`` 6) is initialised in flax in fp32, its params jittered
so the zero-initialised heads and modulations are non-trivial, converted,
and loaded with ``strict=True``. The text embeds are 8 tokens long (cut to
6) and the first sample's mask pads all but 4, so truncation and the
masked joint attention are both exercised. Quantization: group 32,
``min_size`` 1024, on each side from the same float weights.

Tolerances: float and weight-only int4 rtol 2e-4, atol 2e-5 as in
tests/test_torch_flux.py (fp32 matmuls summed in another order). w4a8:
relative L2 2e-4 and max abs 1e-3 on O(1) outputs. Its int4 products are
exact integers, but an activation that JAX and the port see one fp32 ulp
apart can round to neighbouring int8 steps (1/127 of its token's absmax),
and that step propagates; here such flips move single outputs by about
2e-4 and the relative L2 by about 3e-5. A layout or scale error moves the
outputs by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
from arcflow_tpu.models import qwen as jqwen
from arcflow_tpu.utils import quantize as jq
from arcflow_tpu_torch.models import ArcQwenImageTransformer2DModel as TArcQwen
from arcflow_tpu_torch.models import qwen as tqwen
from arcflow_tpu_torch.pipelines import jax_params_to_torch
from arcflow_tpu_torch.utils import quantize_weights_int4

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
W4A8_REL_L2 = 2e-4
W4A8_ATOL = 1e-3
CFG = dict(in_channels=16, num_layers=2, attention_head_dim=32,
           num_attention_heads=2, joint_attention_dim=64,
           axes_dims_rope=(8, 12, 12), max_text_len=6, num_gaussians=4,
           lora_rank=4)
JAX_ONLY = dict(patch_size=2, checkpointing=False, dtype=jnp.float32)
QUANT = dict(min_size=1024, group_size=32)
# int4 layers of the tiny model: 14 per block (two modulations, eight
# attention projections, four MLP projections) + txt_in and the two
# timestep-embedder linears; img_in (16 inputs) is not a multiple of 32
N_INT4 = 14 * CFG['num_layers'] + 3


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    mask = np.ones((2, 8), np.int32)
    mask[0, 4:] = 0
    return dict(hidden_states=rng.standard_normal((2, 8, 8, 4)).astype(f),
                t=np.array([0.25, 0.9], f),
                encoder_hidden_states=rng.standard_normal((2, 8, 64)).astype(f),
                encoder_hidden_states_mask=mask)


def _jax_apply(jm, variables, inp, act_quant=False):
    """A fresh jit per call: JAX reads the w4a8 flag while tracing."""
    try:
        jq.set_act_quant(act_quant)
        return jax.device_get(jax.jit(lambda v, **kw: jm.apply(v, **kw))(
            variables, **{k: jnp.asarray(v) for k, v in inp.items()}))
    finally:
        jq.set_act_quant(False)


def _torch_apply(tm, inp):
    with torch.no_grad():
        return tm(**{k: torch.from_numpy(v) for k, v in inp.items()})


@pytest.fixture(scope='module')
def qwen_pair():
    jm = JArcQwen(**JAX_ONLY, **CFG)
    inp = _inputs()
    params = _jitter(jax.jit(jm.init)(
        jax.random.PRNGKey(0),
        **{k: jnp.asarray(v) for k, v in inp.items()})['params'])
    tm = TArcQwen(dtype=torch.float32, **CFG)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    return jm, params, tm, inp


@pytest.mark.parametrize('key', ['means', 'logweights', 'loggammas'])
def test_arcqwen_outputs_match_jax(qwen_pair, key):
    jm, params, tm, inp = qwen_pair
    want = _jax_apply(jm, {'params': params}, inp)[key]
    got = _torch_apply(tm, inp)[key]
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_text_mask_and_truncation_reach_the_output(qwen_pair):
    """Dropping the mask, or the tokens past ``max_text_len``, changes
    nothing the JAX model would not also change: the port still matches
    JAX, and the masked and unmasked outputs differ."""
    jm, params, tm, inp = qwen_pair
    unmasked = {k: v for k, v in inp.items()
                if k != 'encoder_hidden_states_mask'}
    got = _torch_apply(tm, unmasked)['means'].numpy()
    np.testing.assert_allclose(
        got, np.asarray(_jax_apply(jm, {'params': params}, unmasked)['means']),
        **TOL)
    assert np.abs(got - _torch_apply(tm, inp)['means'].numpy()).max() > 1e-3
    cut = dict(inp, encoder_hidden_states=inp['encoder_hidden_states'][:, :6],
               encoder_hidden_states_mask=inp['encoder_hidden_states_mask'][
                   :, :6])
    np.testing.assert_array_equal(_torch_apply(tm, cut)['means'].numpy(),
                                  _torch_apply(tm, inp)['means'].numpy())


@pytest.mark.parametrize('act_quant', [True, False])
def test_quantized_arcqwen_matches_jax(qwen_pair, act_quant):
    """int4 (w4a8 and weight-only) from the same float weights: the port's
    packed bytes and scales equal the JAX ``quant`` collection, which loads
    strictly into the quantized port model, and the outputs match."""
    jm, params, _, inp = qwen_pair
    qp, quant = jq.quantize_weights_int4(params, **QUANT)
    want = _jax_apply(jm, {'params': qp, 'quant': quant}, inp, act_quant)

    tm = TArcQwen(dtype=torch.float32, **CFG)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    done = quantize_weights_int4(tm, act_quant=act_quant, **QUANT)
    assert len(done) == N_INT4
    state = tm.state_dict()
    from_jax = jax_params_to_torch(jax.device_get(qp), jax.device_get(quant))
    assert set(state) == set(from_jax)
    for k, v in from_jax.items():
        if 'kernel_' in k:
            assert torch.equal(state[k], v), k
    loaded = TArcQwen(dtype=torch.float32, **CFG)
    quantize_weights_int4(loaded, act_quant=act_quant, **QUANT)
    loaded.load_state_dict(from_jax, strict=True)

    got = _torch_apply(tm, inp)
    for key in ('means', 'logweights', 'loggammas'):
        g, w = got[key].numpy(), np.asarray(want[key])
        if not act_quant:
            np.testing.assert_allclose(g, w, **TOL)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=W4A8_ATOL)
        assert np.linalg.norm(g - w) <= W4A8_REL_L2 * np.linalg.norm(w), key
    np.testing.assert_array_equal(_torch_apply(loaded, inp)['means'].numpy(),
                                  got['means'].numpy())


def test_converted_keys_unstack_transformer_blocks(qwen_pair):
    _, params, tm, _ = qwen_pair
    state = jax_params_to_torch(params)
    assert set(state) == set(tm.state_dict())
    w = params['transformer_blocks']['attn']['txt_k']['kernel'][1]
    np.testing.assert_array_equal(
        state['transformer_blocks.1.attn.txt_k.weight'], w.T)
    np.testing.assert_array_equal(state['txt_norm.weight'],
                                  params['txt_norm']['scale'])


def test_qwen_img_ids_match_jax():
    for h, w in ((4, 3), (5, 6)):
        np.testing.assert_array_equal(
            tqwen.make_qwen_img_ids(h, w).numpy(),
            np.asarray(jqwen.make_qwen_img_ids(h, w)))
    assert tqwen.make_qwen_img_ids(4, 4).min() < 0


def test_qwen_has_no_guidance_embeds():
    assert TArcQwen.guidance_embeds is False
    with pytest.raises(TypeError):
        _torch_apply(TArcQwen(dtype=torch.float32, **CFG),
                     dict(_inputs(), guidance=np.ones(2, np.float32)))
