"""The port's diffusers-key maps (``pipelines/convert.py``) against the JAX
package's, bitwise and key for key.

Diffusers states come from random JAX trees (tiny ArcFlux and ArcQwen,
p = 2, K = 4 heads, LoRA rank 2) written out by JAX ``flax_to_torch_flux``,
so they carry the reference's (c, p, p) packed layout; a wrong packed
permutation gives finite but scrambled weights, which only this key-for-key
comparison finds. The port's ``diffusers_to_torch`` must equal
``jax_params_to_torch(torch_flux_to_flax(...)[0])``; the VAE maps, the
proj_out expansion, ``fuse_lora``, ``fuse_pretrained_loras`` and
``graft_pretrained`` are held to their JAX counterparts the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
from arcflow_tpu.models import FluxTransformer2DModel as JFluxTeacher
from arcflow_tpu.pipelines import convert as jconv
from arcflow_tpu.pipelines import save_adapter_state as j_save_adapter
from arcflow_tpu_torch.models import (ArcFluxTransformer2DModel,
                                      ArcQwenImageTransformer2DModel,
                                      PretrainedVAE, PretrainedVAEQwenImage)
from arcflow_tpu_torch.pipelines import (
    diffusers_qwen_vae_to_torch, diffusers_to_torch, diffusers_vae_to_torch,
    expand_proj_out_to_arc_heads, fuse_lora, fuse_pretrained_loras,
    graft_pretrained, jax_params_to_torch, load_safetensors_state,
    torch_to_diffusers)
from test_vae_convert import (synth_autoencoder_kl_state,
                              synth_qwen_vae_state)

FLUX = dict(in_channels=16, num_layers=2, num_single_layers=2,
            attention_head_dim=16, num_attention_heads=2,
            joint_attention_dim=24, pooled_projection_dim=16,
            axes_dims_rope=(4, 6, 6), lora_rank=2)
QWEN = dict(in_channels=16, num_layers=2, attention_head_dim=16,
            num_attention_heads=2, joint_attention_dim=24,
            axes_dims_rope=(4, 6, 6), lora_rank=2)
K = 4


def _random_tree(model, seed, **inputs):
    """A random fp32 param tree of ``model``'s structure (eval_shape only:
    nothing is initialised)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            **inputs)['params']
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)


def _flux_inputs():
    return dict(hidden_states=jnp.zeros((1, 8, 8, 4)), t=jnp.zeros((1,)),
                encoder_hidden_states=jnp.zeros((1, 5, 24)),
                pooled_projections=jnp.zeros((1, 16)),
                guidance=jnp.zeros((1,)))


@pytest.fixture(scope='module')
def trees():
    flux = _random_tree(JArcFlux(num_gaussians=K, guidance_embeds=True,
                                 checkpointing=False, dtype=jnp.float32,
                                 **FLUX), 1, **_flux_inputs())
    qwen = _random_tree(
        JArcQwen(num_gaussians=K, checkpointing=False, dtype=jnp.float32,
                 **QWEN), 2,
        hidden_states=jnp.zeros((1, 8, 8, 4)), t=jnp.zeros((1,)),
        encoder_hidden_states=jnp.zeros((1, 5, 24)),
        encoder_hidden_states_mask=jnp.ones((1, 5), jnp.int32))
    return dict(flux=flux, qwen=qwen)


def _diffusers(tree, family):
    return {k: np.ascontiguousarray(v) for k, v in
            jconv.flax_to_torch_flux(tree, family=family).items()}


def _jax_chain(state, family):
    tree, unused = jconv.torch_flux_to_flax(state, 2, 2, family=family)
    return jax_params_to_torch(tree), unused


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_diffusers_to_torch_equals_the_jax_chain(trees, family):
    state = _diffusers(trees[family], family)
    assert any('.lora_A.weight' in k for k in state)
    assert 'proj_out_means.weight' in state
    state['extra.layer.weight'] = np.ones((3, 3), np.float32)
    got, unused = diffusers_to_torch(state, 2, 2, family=family)
    want, j_unused = _jax_chain(state, family)
    assert_same(got, want)
    assert sorted(unused) == sorted(j_unused) == ['extra.layer.weight']
    # the keys are the port model's, every one
    cls, cfg = (ArcFluxTransformer2DModel, FLUX) if family == 'flux' \
        else (ArcQwenImageTransformer2DModel, QWEN)
    model = cls(num_gaussians=K, dtype=torch.float32, **cfg)
    model.load_state_dict(got, strict=True)


def test_packed_features_are_reordered(trees):
    """x_embedder's input and proj_out_means' output rows move between the
    (c, p, p) and (p, p, c) layouts: the converted weight is not the
    diffusers weight, but it is JAX's."""
    state = _diffusers(trees['flux'], 'flux')
    got, _ = diffusers_to_torch(state, 2, 2)
    for key in ('x_embedder.weight', 'proj_out_means.weight',
                'proj_out_means.bias'):
        assert not np.array_equal(got[key].numpy(), state[key]), key
    # proj_out_means' K groups: each group's rows are permuted on their own
    w = state['proj_out_means.weight'].reshape(K, 4, 4, -1)   # (K, c, p2, D)
    np.testing.assert_array_equal(
        got['proj_out_means.weight'].numpy(),
        w.transpose(0, 2, 1, 3).reshape(K * 16, -1))


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_peft_default_names_are_accepted(trees, family):
    state = _diffusers(trees[family], family)
    peft = {k.replace('.lora_A.weight', '.lora_A.default.weight')
             .replace('.lora_B.weight', '.lora_B.default.weight'): v
            for k, v in state.items()}
    assert any('.default.' in k for k in peft)
    got, unused = diffusers_to_torch(peft, 2, 2, family=family)
    assert not unused
    assert_same(got, _jax_chain(state, family)[0])


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_torch_to_diffusers_inverts_and_equals_jax_export(trees, family):
    state = _diffusers(trees[family], family)
    port, _ = diffusers_to_torch(state, 2, 2, family=family)
    back = torch_to_diffusers(port, family=family)
    assert_same(back, {k: torch.from_numpy(v) for k, v in state.items()})


def test_partial_block_keys_raise(trees):
    state = _diffusers(trees['flux'], 'flux')
    del state['transformer_blocks.1.attn.to_q.weight']
    with pytest.raises(KeyError, match='present for only 1/2'):
        diffusers_to_torch(state, 2, 2)


def test_expand_proj_out_equals_jax():
    teacher = JFluxTeacher(guidance_embeds=True, checkpointing=False,
                           dtype=jnp.float32,
                           **{k: v for k, v in FLUX.items()
                              if k != 'lora_rank'})
    tree = _random_tree(teacher, 3, **_flux_inputs())
    state = _diffusers(tree, 'flux')
    port, _ = diffusers_to_torch(state, 2, 2)
    want = jax_params_to_torch(jconv.expand_proj_out_to_arc_heads(
        jconv.torch_flux_to_flax(state, 2, 2)[0], K, 2,
        rng=jax.random.PRNGKey(5)))
    noise = np.array(jax.random.normal(jax.random.PRNGKey(5), (K, 4),
                                       jnp.float32))
    got = expand_proj_out_to_arc_heads(port, K, 2,
                                       noise=torch.from_numpy(noise))
    assert 'proj_out.weight' not in got
    assert_same(got, want)
    # the default draws are the port's own stream: only the bias differs
    other = expand_proj_out_to_arc_heads(port, K, 2)
    assert torch.equal(other['proj_out_means.weight'],
                       got['proj_out_means.weight'])


def test_fuse_lora_equals_jax(trees):
    tree = trees['flux']
    want = jax_params_to_torch(jax.device_get(jconv.fuse_lora(tree, 0.7)))
    got = fuse_lora(jax_params_to_torch(tree), 0.7)
    assert not any(k.endswith(('.lora_a', '.lora_b')) for k in got)
    assert_same(got, want)


def test_fuse_pretrained_loras_equals_jax(trees, tmp_path):
    """Two adapter files written by JAX, folded in order at their scales
    into a base without LoRA leaves."""
    from arcflow_tpu.utils.pytree import flatten, partition_params, unflatten
    tree = trees['flux']
    base = unflatten({k: v for k, v in flatten(tree).items()
                      if not k.endswith(('.lora_a', '.lora_b'))})
    paths = []
    for i in range(2):
        lora, _ = partition_params(tree, ('lora_a', 'lora_b'))
        lora = jax.tree.map(lambda x: x * (1.0 + i), lora)
        paths.append(str(tmp_path / f'lora{i}.safetensors'))
        j_save_adapter(paths[-1], jax.device_get(lora), family='flux')
    want = jax_params_to_torch(jax.device_get(
        jconv.fuse_pretrained_loras(base, paths, [0.5, 2.0])))
    got = fuse_pretrained_loras(jax_params_to_torch(base), paths, [0.5, 2.0])
    assert_same(got, want)


def test_graft_pretrained_reports_missing_and_unexpected(trees):
    from arcflow_tpu.utils.pytree import flatten, unflatten
    flat = flatten(trees['qwen'])
    partial = {k: v + 1.0 for k, v in list(flat.items())[::2]}
    partial['not.a.param.kernel'] = np.zeros((2, 2), np.float32)
    j_tree, j_missing, j_unexpected = jconv.graft_pretrained(
        trees['qwen'], unflatten(partial))
    init = jax_params_to_torch(trees['qwen'])
    port_partial = jax_params_to_torch(unflatten(partial))
    got, missing, unexpected = graft_pretrained(init, port_partial)
    assert_same(got, {k: v for k, v in jax_params_to_torch(
        jax.device_get(j_tree)).items()})
    # JAX counts a stacked leaf once, the port each block's
    assert sorted(missing) == sorted(jax_params_to_torch(
        unflatten({k: flat[k] for k in j_missing})))
    assert j_unexpected == ['not.a.param.kernel']
    assert unexpected == ['not.a.param.weight']
    bad = dict(port_partial, **{next(iter(init)): torch.zeros(1, 1, 1)})
    with pytest.raises(ValueError, match='shape mismatch'):
        graft_pretrained(init, bad)


def _decoder_half(state):
    return {k: v for k, v in state.items()
            if k.startswith(('decoder.', 'post_quant_conv.'))}


def test_flux_vae_map_equals_jax():
    state = synth_autoencoder_kl_state(block_out=(32, 64), layers=1, z=4)
    got, unused = diffusers_vae_to_torch(state)
    want = _decoder_half(jax_params_to_torch(
        jconv.torch_vae_to_flax(state)[0]))
    assert_same(got, want)
    assert all(k.startswith(('encoder.', 'quant_conv.')) for k in unused)
    vae = PretrainedVAE(latent_channels=4, block_out_channels=(32, 64),
                        layers_per_block=1, use_post_quant_conv=True,
                        dtype=torch.float32)
    vae.load_state_dict(got, strict=True)


def test_qwen_vae_map_equals_jax():
    state = synth_qwen_vae_state(base=32, mult=(1, 2), nres=1, z=4)
    got, unused = diffusers_qwen_vae_to_torch(state)
    want = _decoder_half(jax_params_to_torch(
        jconv.torch_qwen_vae_to_flax(state)[0]))
    assert_same(got, want)
    assert not any('.time_conv.' in k for k in got)
    vae = PretrainedVAEQwenImage(base_dim=32, z_dim=4, dim_mult=(1, 2),
                                 num_res_blocks=1, dtype=torch.float32)
    vae.load_state_dict(got, strict=True)


def test_load_safetensors_state_reads_sharded_folders(tmp_path, trees):
    import json
    from safetensors.numpy import save_file
    state = _diffusers(trees['qwen'], 'qwen')
    keys = sorted(state)
    shards = {'a.safetensors': keys[::2], 'b.safetensors': keys[1::2]}
    for name, ks in shards.items():
        save_file({k: state[k] for k in ks}, str(tmp_path / name))
    with open(tmp_path / 'model.safetensors.index.json', 'w') as f:
        json.dump({'weight_map': {k: n for n, ks in shards.items()
                                  for k in ks}}, f)
    for path in (str(tmp_path),
                 str(tmp_path / 'model.safetensors.index.json')):
        got = load_safetensors_state(path)
        assert_same(got, {k: torch.from_numpy(v) for k, v in state.items()})
    with pytest.raises(NotImplementedError, match='queue A item 7'):
        load_safetensors_state('huggingface://org/repo')
