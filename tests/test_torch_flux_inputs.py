"""Port parity: the FLUX DiT's ControlNet and Flux-fill inputs, both FLUX
classes (the ArcFlux student and the ``FluxTransformer2DModel`` teacher),
against the JAX models, and ``ArcFlowPolicy.means_x0`` / ``rates_full``.

Tiny models (3 joint + 2 single blocks, 2 heads x 16, K=4, LoRA rank 4):
flax init in fp32, params jittered, converted with ``jax_params_to_torch``
and loaded with ``strict=True``, as in ``tests/test_torch_flux.py``, whose
tolerance (rtol=2e-4, atol=2e-5: fp32 sums in another order) holds here.
ControlNet: 2 joint-block samples on the interval map (blocks 0, 0, 1) and
on the repeat map (0, 1, 0), 2 single-block samples on the interval map
(0, 1).
Fill: the 4 latent channels + 4 masked-image channels + an 8-channel mask
per latent cell, patchified (16 + 16 + 32 features into ``x_embedder``,
whose kernel is the plain model's params' with 64 jittered input rows);
the heads keep the latents' width (``out_channels`` 16). Every input must
move the output, and a second mask must give another one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.diffusion.policies.arcflow import \
    ArcFlowPolicy as JArcFlowPolicy
from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
from arcflow_tpu.models import FluxTransformer2DModel as JFlux
from arcflow_tpu_torch.diffusion.policies.arcflow import ArcFlowPolicy
from arcflow_tpu_torch.models import ArcFluxTransformer2DModel as TArcFlux
from arcflow_tpu_torch.models import FluxTransformer2DModel as TFlux
from arcflow_tpu_torch.models.flux import controlnet_index
from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
CFG = dict(num_layers=3, num_single_layers=2, attention_head_dim=16,
           num_attention_heads=2, joint_attention_dim=24,
           pooled_projection_dim=16, axes_dims_rope=(4, 6, 6), lora_rank=4)
JAX_ONLY = dict(guidance_embeds=True, patch_size=2, checkpointing=False,
                dtype=jnp.float32)
LATENT_C, MASK_C = 4, 8
FILL_IN = 4 * (2 * LATENT_C + MASK_C)
CLASSES = {'arcflux': (JArcFlux, TArcFlux, dict(num_gaussians=4)),
           'teacher': (JFlux, TFlux, {})}


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(hidden_states=rng.standard_normal((2, 8, 8, 4)).astype(f),
                t=np.array([0.25, 0.9], f),
                encoder_hidden_states=rng.standard_normal((2, 5, 24)).astype(f),
                pooled_projections=rng.standard_normal((2, 16)).astype(f),
                guidance=np.array([3.5, 1.0], f))


def _controlnet(seed=5):
    rng = np.random.default_rng(seed)
    joint = [0.3 * rng.standard_normal((2, 16, 32)).astype(np.float32)
             for _ in range(2)]
    single = [0.3 * rng.standard_normal((2, 16, 32)).astype(np.float32)
              for _ in range(2)]
    return joint, single


def _fill(seed=6):
    rng = np.random.default_rng(seed)
    masked = rng.standard_normal((2, 8, 8, LATENT_C)).astype(np.float32)
    mask = (rng.random((2, 8, 8, MASK_C)) > 0.5).astype(np.float32)
    return masked, mask


def _jitter(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


@pytest.fixture(scope='module', params=list(CLASSES))
def pair(request):
    """(JAX model, its jittered params, port model) for the plain width
    and for the fill width (the same params with a wider ``x_embedder``)."""
    j_cls, t_cls, extra = CLASSES[request.param]
    jm = j_cls(**JAX_ONLY, **CFG, **extra, in_channels=16)
    kw = {k: jnp.asarray(v) for k, v in _inputs().items()}
    params = _jitter(jax.jit(jm.init)(jax.random.PRNGKey(0), **kw)['params'])
    rng = np.random.default_rng(8)
    fill_params = dict(params, x_embedder=dict(
        params['x_embedder'], kernel=0.1 * rng.standard_normal(
            (FILL_IN, 32)).astype(np.float32)))
    out = {}
    for fill, p in ((False, params), (True, fill_params)):
        tm = t_cls(dtype=torch.float32, **CFG, **extra,
                   **(dict(in_channels=FILL_IN, out_channels=16) if fill
                      else dict(in_channels=16)))
        tm.load_state_dict(jax_params_to_torch(p), strict=True)
        out[fill] = (j_cls(**JAX_ONLY, **CFG, **extra,
                           in_channels=FILL_IN if fill else 16), p, tm)
    return request.param, out


_JIT = {}


def _jitted(jm):
    """``jm.apply`` under ``jax.jit``, one per model (eager flax costs
    seconds a call)."""
    if id(jm) not in _JIT:
        _JIT[id(jm)] = (jm, jax.jit(
            jm.apply, static_argnames=('controlnet_blocks_repeat',)))
    return _JIT[id(jm)][1]


def _run(jm, params, tm, **extra):
    inp = _inputs()
    j_kw = {k: jnp.asarray(v) for k, v in inp.items()}
    t_kw = {k: torch.from_numpy(v) for k, v in inp.items()}
    for k, v in extra.items():
        if isinstance(v, list):
            j_kw[k] = [jnp.asarray(x) for x in v]
            t_kw[k] = [torch.from_numpy(x) for x in v]
        elif isinstance(v, np.ndarray):
            j_kw[k], t_kw[k] = jnp.asarray(v), torch.from_numpy(v)
        else:
            j_kw[k] = t_kw[k] = v
    j_out = _jitted(jm)({'params': params}, **j_kw)
    with torch.no_grad():
        t_out = tm(**t_kw)
    if not isinstance(j_out, dict):
        j_out, t_out = dict(u=j_out), dict(u=t_out)
    return {k: np.asarray(v) for k, v in j_out.items()}, \
        {k: v.numpy() for k, v in t_out.items()}


def _close(j_out, t_out):
    assert j_out.keys() == t_out.keys()
    for k in j_out:
        assert t_out[k].shape == j_out[k].shape, k
        np.testing.assert_allclose(t_out[k], j_out[k], err_msg=k, **TOL)


def _moved(a, b):
    return any(not np.allclose(a[k], b[k], rtol=1e-3, atol=1e-4) for k in a)


@pytest.mark.parametrize('case', ['interval', 'repeat', 'single', 'both'])
def test_controlnet_matches_jax(pair, case):
    name, models = pair
    jm, params, tm = models[False]
    joint, single = _controlnet()
    extra = {}
    if case in ('interval', 'repeat', 'both'):
        extra['controlnet_block_samples'] = joint
        extra['controlnet_blocks_repeat'] = case == 'repeat'
    if case in ('single', 'both'):
        extra['controlnet_single_block_samples'] = single
    j_out, t_out = _run(jm, params, tm, **extra)
    _close(j_out, t_out)
    _, plain = _run(jm, params, tm)
    assert _moved(t_out, plain), f'{name} {case}: the residuals did nothing'


def test_interval_and_repeat_maps_differ(pair):
    _, models = pair
    jm, params, tm = models[False]
    joint, _ = _controlnet()
    _, a = _run(jm, params, tm, controlnet_block_samples=joint)
    _, b = _run(jm, params, tm, controlnet_block_samples=joint,
                controlnet_blocks_repeat=True)
    assert _moved(a, b)


def test_fill_matches_jax_and_the_mask_matters(pair):
    name, models = pair
    jm, params, tm = models[True]
    masked, mask = _fill()
    j_out, t_out = _run(jm, params, tm, masked_image_latents=masked,
                        mask=mask)
    _close(j_out, t_out)
    shape = (2, 4, 8, 8, 4) if name == 'arcflux' else (2, 8, 8, 4)
    first = 'means' if name == 'arcflux' else 'u'
    assert t_out[first].shape == shape
    j_b, t_b = _run(jm, params, tm, masked_image_latents=masked,
                    mask=1.0 - mask)
    _close(j_b, t_b)
    assert _moved(t_out, t_b), f'{name}: the mask did nothing'


def test_controlnet_index_maps():
    assert controlnet_index(2, 3, False) == [0, 0, 1]
    assert controlnet_index(2, 3, True) == [0, 1, 0]
    # FLUX: 19 joint blocks from 5 samples, 38 single blocks from 10
    assert controlnet_index(5, 19, False) == [i // 4 for i in range(19)]
    assert controlnet_index(10, 38, False) == [i // 4 for i in range(38)]
    assert controlnet_index(5, 19, True) == [i % 5 for i in range(19)]


def test_policy_means_x0_and_rates_full_match_jax():
    rng = np.random.default_rng(0)
    f = np.float32
    out = dict(means=rng.standard_normal((2, 4, 3, 5, 6)).astype(f),
               logweights=rng.standard_normal((2, 4, 3, 5, 1)).astype(f),
               loggammas=rng.standard_normal((2, 3, 3, 5, 1)).astype(f))
    x = rng.standard_normal((2, 3, 5, 6)).astype(f)
    sigma = np.array([0.3, 0.8], f)
    jp = JArcFlowPolicy.create({k: jnp.asarray(v) for k, v in out.items()},
                               jnp.asarray(x), jnp.asarray(sigma))
    tp = ArcFlowPolicy.create({k: torch.from_numpy(v)
                               for k, v in out.items()},
                              torch.from_numpy(x), torch.from_numpy(sigma))
    assert tp.num_components == jp.num_components == 4
    np.testing.assert_allclose(tp.means_x0.numpy(), np.asarray(jp.means_x0),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(tp.rates_full().numpy(),
                                  np.asarray(jp.rates_full()))
    assert tp.rates_full().shape == (2, 4, 3, 5, 1)
