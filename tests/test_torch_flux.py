"""Port parity: ArcFluxTransformer2DModel (arcflow_tpu_torch.models.flux) and
the param carry-over (``jax_params_to_torch``) against the JAX model.

A tiny ArcFlux (2 joint + 2 single blocks, 2 heads x 16, K=4, LoRA rank 4)
is initialised in flax in fp32, its params jittered so the zero-initialised
heads and modulations are non-trivial, converted, and loaded with
``strict=True``. Tolerance rtol=2e-4, atol=2e-5 as in
tests/test_torch_block_parity.py: fp32 matmuls summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
from arcflow_tpu.models import flux as jflux
from arcflow_tpu_torch.models import ArcFluxTransformer2DModel as TArcFlux
from arcflow_tpu_torch.models import flux as tflux
from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
CFG = dict(in_channels=16, num_layers=2, num_single_layers=2,
           attention_head_dim=16, num_attention_heads=2,
           joint_attention_dim=24, pooled_projection_dim=16,
           axes_dims_rope=(4, 6, 6), num_gaussians=4, lora_rank=4)
# fixed in the port (FLUX.1-dev's values), fields of the JAX model
JAX_ONLY = dict(guidance_embeds=True, patch_size=2, checkpointing=False,
                dtype=jnp.float32)


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(hidden_states=rng.standard_normal((2, 8, 8, 4)).astype(f),
                t=np.array([0.25, 0.9], f),
                encoder_hidden_states=rng.standard_normal((2, 5, 24)).astype(f),
                pooled_projections=rng.standard_normal((2, 16)).astype(f),
                guidance=np.array([3.5, 1.0], f))


@pytest.fixture(scope='module')
def flux_pair():
    jm = JArcFlux(**JAX_ONLY, **CFG)
    inp = _inputs()
    init = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0),
        **{k: jnp.asarray(v) for k, v in inp.items()})['params'])
    params = _jitter(init)
    tm = TArcFlux(dtype=torch.float32, **CFG)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    j_out = jax.jit(jm.apply)({'params': params},
                              **{k: jnp.asarray(v) for k, v in inp.items()})
    with torch.no_grad():
        t_out = tm(**{k: torch.from_numpy(v) for k, v in inp.items()})
    return init, params, tm, j_out, t_out


@pytest.mark.parametrize('key', ['means', 'logweights', 'loggammas'])
def test_arcflux_outputs_match_jax(flux_pair, key):
    _, _, _, j_out, t_out = flux_pair
    assert tuple(t_out[key].shape) == tuple(j_out[key].shape)
    assert t_out[key].dtype == torch.float32
    np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]),
                               **TOL)


def test_jax_params_to_torch_loads_strict(flux_pair):
    """Every converted key lands on a port parameter of the same shape, and
    the scan axis became the ModuleList index."""
    _, params, tm, _, _ = flux_pair
    state = jax_params_to_torch(params)
    assert set(state) == set(tm.state_dict())
    assert 'joint_blocks.1.attn.img_q.weight' in state
    assert 'single_blocks.1.attn.k_norm.weight' in state
    w = params['joint_blocks']['attn']['img_q']['kernel'][1]
    np.testing.assert_array_equal(state['joint_blocks.1.attn.img_q.weight'],
                                  w.T)
    lora = params['single_blocks']['proj_out']['lora_a'][0]
    np.testing.assert_array_equal(state['single_blocks.0.proj_out.lora_a'],
                                  lora)
    with pytest.raises(RuntimeError, match='Missing key'):
        TArcFlux(dtype=torch.float32, **CFG).load_state_dict(
            {k: v for k, v in state.items() if 'norm_out' not in k},
            strict=True)


def test_head_init_semantics_match_jax(flux_pair):
    """Zero head kernels, logweights bias 0, loggamma bias log-spaced rates
    in [0.2, 4], means bias shared over the p*p cells of a patch."""
    k, p, c = 4, 2, 4
    jp = flux_pair[0]
    tm = TArcFlux(dtype=torch.float32, **CFG)
    for name in ('proj_out_means', 'proj_out_logweights', 'proj_out_loggamma'):
        assert not getattr(tm, name).weight.any()
        assert not np.any(jp[name]['kernel'])
    np.testing.assert_allclose(tm.proj_out_loggamma.bias.detach().numpy(),
                               jp['proj_out_loggamma']['bias'], rtol=1e-6)
    assert not tm.proj_out_logweights.bias.any()
    mb = tm.proj_out_means.bias.detach().reshape(k, p * p, c)
    assert torch.equal(mb, mb[:, :1].expand(k, p * p, c))
    assert tm.norm_out.modulation.weight.abs().sum() == 0


def test_patchify_and_ids_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    tp = tflux.patchify(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tp.numpy(),
                                  np.asarray(jflux.patchify(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(tflux.unpatchify(tp, 8, 6, 2).numpy(), x)
    np.testing.assert_array_equal(tflux.make_img_ids(4, 3).numpy(),
                                  np.asarray(jflux.make_img_ids(4, 3)))
