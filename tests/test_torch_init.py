"""The port's random initialisation against the JAX modules': each parameter
of a freshly built port module is drawn from the distribution the JAX
module draws the same parameter from (flax's defaults: truncated LeCun
normal kernels with fan-in = every axis but the output one, zero biases;
the modules' own initialisers where they set one).

Compared by sampling statistics, since the two frameworks draw different
numbers: for each parameter, the port's standard deviation against JAX's
within 6 / sqrt(n) relative (two independent estimates of one sigma from n
draws differ by about 1 / sqrt(n)), the means within 6 sigma / sqrt(n),
every truncated kernel within the 2-sigma cut, and the constant parameters
(zero biases and kernels, unit norm scales, the fixed loggamma bias)
equal. n counts the independent draws, the distinct values of the JAX
parameter: a bias drawn per channel and broadcast over a patch's cells
holds fewer draws than elements. The port draws under a fixed torch seed,
so the result does not depend on what ran before in the process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
from arcflow_tpu.models import PretrainedVAE as JVAE
from arcflow_tpu.models import PretrainedVAEQwenImage as JQwenVAE
from arcflow_tpu.models import layers as jlayers
from arcflow_tpu_torch.models import ArcFluxTransformer2DModel as TArcFlux
from arcflow_tpu_torch.models import ArcQwenImageTransformer2DModel as TArcQwen
from arcflow_tpu_torch.models import PretrainedVAE as TVAE
from arcflow_tpu_torch.models import PretrainedVAEQwenImage as TQwenVAE
from arcflow_tpu_torch.models import layers as tlayers
from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)


def _jax_state(module, *args, **kw):
    """The JAX module's freshly initialised params as a port state dict."""
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *args, **kw)
    return jax_params_to_torch(jax.device_get(params['params']))


def _seeded_build(cls, **kw):
    """``cls(**kw)`` drawn under torch seed 0, leaving the global
    generator as it was."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return cls(**kw)


def _compare(port, jax_state):
    """Every parameter of ``port`` against the same-named JAX one."""
    got = {k: v.detach().double() for k, v in port.state_dict().items()}
    assert sorted(got) == sorted(jax_state)
    kernels = 0
    for key, want in jax_state.items():
        want, have = want.double(), got[key]
        assert have.shape == want.shape, key
        if torch.all(want == want.flatten()[0]):      # a constant
            assert torch.equal(have, want), key
            continue
        n = torch.unique(want).numel()               # independent draws
        s_want, s_have = want.std().item(), have.std().item()
        assert abs(s_have - s_want) <= 6 / np.sqrt(n) * s_want, \
            (key, s_have, s_want)
        assert abs(have.mean().item() - want.mean().item()) <= \
            6 * s_want / np.sqrt(n), key
        if key.split('.')[-1] == 'weight' and want.dim() >= 2 and n > 64:
            fan_in = want[0].numel()
            cut = 2 / np.sqrt(fan_in) / 0.87962566103423978
            assert have.abs().max() <= cut * (1 + 1e-6), key
            kernels += 1
    return kernels


def test_lora_dense_draws_flax_defaults():
    """LeCun-normal kernel, zero bias, N(0, 1/r) LoRA A, zero LoRA B."""
    jm = jlayers.LoRADense(384, lora_rank=8, dtype=jnp.float32)
    want = _jax_state(jm, jnp.zeros((1, 256)))
    assert _compare(tlayers.LoRADense(256, 384, lora_rank=8), want) == 1
    layer = tlayers.LoRADense(256, 384)
    assert torch.all(layer.bias == 0)
    assert abs(layer.weight.std().item() * 16 - 1) < 0.02   # 1/sqrt(256)


def test_arcflux_draws_as_the_jax_model():
    cfg = dict(in_channels=64, num_layers=1, num_single_layers=1,
               attention_head_dim=32, num_attention_heads=4,
               joint_attention_dim=96, pooled_projection_dim=48,
               axes_dims_rope=(8, 12, 12), num_gaussians=4, lora_rank=8)
    jm = JArcFlux(guidance_embeds=True, patch_size=2, checkpointing=False,
                  dtype=jnp.float32, **cfg)
    want = _jax_state(jm, jnp.zeros((1, 8, 8, 16)), t=jnp.ones((1,)),
                      encoder_hidden_states=jnp.zeros((1, 4, 96)),
                      pooled_projections=jnp.zeros((1, 48)),
                      guidance=jnp.ones((1,)))
    assert _compare(_seeded_build(TArcFlux, dtype=torch.float32, **cfg),
                    want) > 20


def test_arcqwen_draws_as_the_jax_model():
    cfg = dict(in_channels=64, num_layers=1, attention_head_dim=32,
               num_attention_heads=4, joint_attention_dim=96,
               axes_dims_rope=(8, 12, 12), max_text_len=8, num_gaussians=4,
               lora_rank=8)
    jm = JArcQwen(patch_size=2, checkpointing=False, dtype=jnp.float32,
                  **cfg)
    want = _jax_state(jm, jnp.zeros((1, 8, 8, 16)), t=jnp.ones((1,)),
                      encoder_hidden_states=jnp.zeros((1, 4, 96)),
                      encoder_hidden_states_mask=jnp.ones((1, 4), jnp.int32))
    assert _compare(_seeded_build(TArcQwen, dtype=torch.float32, **cfg),
                    want) > 10


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_vae_decoders_draw_as_the_jax_modules(family):
    """Every conv and linear of the decoder: flax's ``nn.Conv``/``nn.Dense``
    defaults (fan-in = in x kh x kw for a conv), zero biases."""
    if family == 'flux':
        cfg = dict(latent_channels=4, block_out_channels=(32, 64))
        jv = JVAE(dtype='float32', **cfg)
        tv = _seeded_build(TVAE, dtype=torch.float32, **cfg)
        z = jnp.zeros((1, 4, 4, 4))
        want = jax_params_to_torch(jax.device_get({'decoder': jax.jit(
            jv.decoder.init)(jax.random.PRNGKey(0), z)['params']}))
    else:
        cfg = dict(base_dim=32, z_dim=4, dim_mult=(1, 2), num_res_blocks=1)
        jv = JQwenVAE(dtype='float32', **cfg)
        tv = _seeded_build(TQwenVAE, dtype=torch.float32, **cfg)
        z = jnp.zeros((1, 4, 4, 4))
        want = jax_params_to_torch(jax.device_get({
            'decoder': jax.jit(jv.decoder.init)(jax.random.PRNGKey(0),
                                                z)['params'],
            'post_quant_conv': jax.jit(jv.post_quant_conv.init)(
                jax.random.PRNGKey(1), z)['params']}))
    assert _compare(tv, want) > 5
