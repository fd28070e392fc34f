"""Port parity: the ADM UNet and its ArcFlow student (``models/unet.py``)
against the JAX modules.

Every parameter of the flax tree (its shapes from ``jax.eval_shape``) is
drawn from a numpy seed, so the zero-initialised ``conv2``, ``proj``,
``conv_out`` and mixture heads are live, and carried over with
``jax_params_to_torch`` under ``strict=True``. Inputs come from a numpy
seed. Tolerance: relative L2 1e-5 on every output, fp32 (JAX at its
'highest' matmul precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import ArcDenoisingUnetMod as JArcUnet
from arcflow_tpu.models import DenoisingUnetMod as JUnet
from arcflow_tpu_torch import MODULES
from arcflow_tpu_torch.models import ArcDenoisingUnetMod, DenoisingUnetMod
from arcflow_tpu_torch.pipelines import jax_params_to_torch

REL_L2 = 1e-5
TINY = dict(in_channels=4, base_channels=32, channel_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(4,), num_classes=10,
            num_heads=4)
LAT = (8, 8, 4)
SHIPPED = dict(in_channels=4, base_channels=128, channel_mult=(1, 2, 4),
               num_res_blocks=2, attn_resolutions=(16, 8), num_classes=1000,
               num_heads=8)
SHIPPED_PARAMS = {'DenoisingUnetMod': 67_481_988,
                  'ArcDenoisingUnetMod': 67_531_567}


def random_flax_params(module, seed, c=4, hw=8):
    """Seeded random params of the flax ``module``'s tree (its shapes from
    ``jax.eval_shape``, so nothing is compiled): kernels N(0, 1 / fan-in),
    embeddings N(0, 1 / features), norm scales 1 + 0.05 N(0, 1), biases
    0.05 N(0, 1). Every zero-initialised head and residual conv is live."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hw, hw, c)), jnp.zeros((1,)),
                            label=jnp.zeros((1,), jnp.int32))['params']
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape)
        if name == 'kernel':
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif name == 'embedding':
            x = x / np.sqrt(s.shape[-1])
        else:
            x = 0.05 * x + (name == 'scale')
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def inputs(b=3, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *LAT)).astype(np.float32)
    t = rng.uniform(0, 1000, b).astype(np.float32)
    y = np.array([3, 10, 7][:b], np.int32)       # 10: the null class
    return x, t, y


@pytest.fixture(scope='module')
def cases():
    """{name: (port module, JAX outputs)} for both UNets, same weights."""
    x, t, y = inputs()
    out = {}
    for name, j_cls, t_cls, extra in (
            ('unet', JUnet, DenoisingUnetMod, {}),
            ('arc', JArcUnet, ArcDenoisingUnetMod, dict(num_gaussians=3))):
        jm = j_cls(**TINY, **extra)
        params = random_flax_params(jm, 7)
        want = jax.jit(jm.apply)({'params': params}, x, t, label=y)
        tm = t_cls(**TINY, **extra, data_shape=LAT, device='cpu')
        tm.load_state_dict(jax_params_to_torch(params), strict=True)
        out[name] = (tm, jax.device_get(want))
    return out


def test_unet_matches_jax(cases):
    tm, want = cases['unet']
    x, t, y = inputs()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 label=torch.from_numpy(y))
    assert got.shape == x.shape
    assert rel_l2(got.numpy(), want) < REL_L2


def test_arc_unet_matches_jax_on_every_output(cases):
    tm, want = cases['arc']
    x, t, y = inputs()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 label=torch.from_numpy(y))
    assert set(got) == set(want) == {'means', 'logweights', 'loggammas'}
    assert got['means'].shape == (3, 3, *LAT)
    assert got['logweights'].shape == (3, 3, 8, 8, 1)
    assert got['loggammas'].shape == (3, 2, 8, 8, 1)
    for k in want:
        assert rel_l2(got[k].numpy(), want[k]) < REL_L2, k


def test_means_channel_order_is_k_major(cases):
    """Output channel k * C + c of the means conv is mixture k, channel c
    (JAX reshapes (B, H, W, K * C) to (..., K, C))."""
    tm, _ = cases['arc']
    x, t, y = inputs()
    with torch.no_grad():
        raw = torch.nn.functional.conv2d(
            tm._trunk(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(y)),
            tm.proj_out_means.weight, tm.proj_out_means.bias, padding=1)
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 label=torch.from_numpy(y))['means']
    np.testing.assert_array_equal(got[:, 1, 2, 5, 3].numpy(),
                                  raw[:, 1 * 4 + 3, 2, 5].numpy())


def test_unet_refuses_another_resolution(cases):
    tm, _ = cases['unet']
    with pytest.raises(ValueError, match='built for 8 x 8'):
        tm(torch.zeros(1, 16, 16, 4), torch.zeros(1),
           label=torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError, match='needs labels'):
        tm(torch.zeros(1, *LAT), torch.zeros(1))


def test_arc_unet_init_contract():
    """Zero conv kernels on the heads, ``conv2`` and ``proj``; the
    loggamma bias log(logspace(0.2, 4, K - 1)) as JAX's init (read from
    ``eval_shape``'s trace of it); the class embedding has num_classes + 1
    rows; the parameter names are the JAX tree's."""
    jm = JArcUnet(**TINY, num_gaussians=5)
    j_bias = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *LAT)), jnp.zeros((1,)),
        label=jnp.zeros((1,), jnp.int32))['params']['proj_out_loggamma'][
            'bias'])
    torch.manual_seed(0)
    tm = ArcDenoisingUnetMod(**TINY, num_gaussians=5, data_shape=LAT,
                             device='cpu')
    for name in ('proj_out_means', 'proj_out_logweights', 'proj_out_loggamma',
                 'down_0_0.conv2', 'mid_attn.proj'):
        assert not tm.get_submodule(name).weight.any(), name
    np.testing.assert_allclose(tm.proj_out_loggamma.bias.detach().numpy(),
                               np.asarray(j_bias()), rtol=1e-6)
    assert 0.03 < tm.proj_out_means.bias.std() < 0.3
    assert tm.class_embed.weight.shape == (11, 128)
    assert set(jax_params_to_torch(random_flax_params(jm, 0))) == \
        set(tm.state_dict())


def test_registered_and_counted_at_the_shipped_widths():
    """The port's UNets count what the JAX modules count at the shipped
    widths (``configs/imagenet``), built on the meta device."""
    for name, want in SHIPPED_PARAMS.items():
        extra = dict(num_gaussians=8) if name.startswith('Arc') else {}
        m = MODULES.build(dict(type=name, **SHIPPED, **extra),
                          default_args=dict(device='meta',
                                            data_shape=(32, 32, 4)))
        assert sum(p.numel() for p in m.parameters()) == want, name
    shapes = jax.eval_shape(
        JUnet(**SHIPPED).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
        label=jnp.zeros((1,), jnp.int32))['params']
    assert sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes)) \
        == SHIPPED_PARAMS['DenoisingUnetMod']
