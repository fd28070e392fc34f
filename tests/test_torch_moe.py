"""Port parity for the expert-choice MoE FFN and expert parallelism
(``models/layers.py:MoEFeedForward``, ``parallel/expert.py``) against the
JAX package on the CPU.

* ``MoEFeedForward`` forward and ``jax.grad`` (of sum y^2, in the
  parameters and the input) for E in {1, 2, 4} and capacity factor in
  {0.5, 1, 2}, in fp32 and bf16, JAX's weights carried over with
  ``jax_params_to_torch`` (the ``moe`` leaves are raw parameters: not
  transposed) and loaded with ``strict=True``. Weights and inputs from a
  seeded numpy draw (``seeded_params``: JAX's init is costly to compile),
  so no two scores tie. fp32: output rtol 1e-5, atol 1e-5 (JAX's own
  ``test_single_expert_full_capacity_equals_dense_ffn`` bound), gradients
  rtol 2e-4, atol 2e-5 (sums in another order). bf16: JAX sums the
  experts' contributions in bf16 (``einsum('becs,becd,bec->bsd')``) where
  the port sums them in fp32 and casts once, and each side rounds its
  products to bf16 in its own order: output and gradients within 3e-2
  relative L2 (a few bf16 ulps, 2^-8 each, over two matmuls and a sum).
* The single expert at full capacity equals the dense FFN; capacity is
  JAX's integer formula; a token no expert picks gets exactly 0; tied
  scores go to the lower token index, as ``lax.top_k`` breaks them.
* Tiny ArcFlux and ArcQwen with ``moe_experts=2`` against JAX's ``apply``
  (JAX's MoE tolerance, rtol 2e-3, atol 2e-4), ``ToyArcFlowDenoiser(
  moe_experts=4)`` against JAX at fp32's, and the distillation's split:
  the MoE leaves are frozen, as JAX's ``freeze_exclude``.
* Expert parallelism on 2 x 2 gloo ranks (``expert=2 x data=2``): each
  rank holds 2 of 4 experts and its batch rows; forward and gradients
  (the experts' gathered from their ranks, the router's and the input's on
  every rank) against single-device JAX, at JAX's EP test bounds (output
  rtol 2e-4, atol 2e-5; gradients rtol 2e-3, atol 2e-4): ``ep_on_rank``
  and ``check_ep``, run in the one 4-rank spawn of
  ``tests/test_torch_pipeline_parallel.py`` (a spawn costs seconds).
* The ownership of experts against JAX's ``moe_param_spec`` /
  ``param_spec_for_path``, and the traps: the toy's MoE under a data mesh
  and MoE blocks under ``sp`` are refused by name.

JAX runs only in the test process; the module imports JAX only inside
functions, so the ranks that run ``ep_on_rank`` import none.
"""

import copy
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from arcflow_tpu_torch.models import (ArcFluxTransformer2DModel,
                                      ArcQwenImageTransformer2DModel)
from arcflow_tpu_torch.models.layers import FeedForward, MoEFeedForward
from arcflow_tpu_torch.parallel import (ExpertParallel, SequenceParallel,
                                        make_mesh, set_sequence_parallel,
                                        setup_distributed)
from arcflow_tpu_torch.parallel.mesh import (batch_ranks, batch_rows,
                                             moe_param_spec,
                                             param_spec_for_path)
from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)

F32_OUT = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=2e-4, atol=2e-5)
BF16_REL_L2 = 3e-2
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
EP_OUT = dict(rtol=2e-4, atol=2e-5)
EP_GRAD = dict(rtol=2e-3, atol=2e-4)
D, S, B = 16, 8, 2


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def seeded_params(shapes, seed):
    """A param tree of ``shapes`` (``jax.eval_shape`` of an init) drawn
    with numpy: LeCun-scaled normals for the matrices (fan-in the
    second-to-last axis' size times the leading ones, flax's count), 1 +
    0.05 N(0, 1) for norm scales, 0.1 N(0, 1) for the rest."""
    import jax
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], 'key', path[-1]))
        x = rng.standard_normal(sd.shape).astype(np.float32)
        if len(sd.shape) >= 2:
            return x / np.sqrt(np.prod(sd.shape[:-1]))
        return x * 0.05 + 1.0 if name == 'scale' else x * 0.1
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_moe(e, cf, dtype, x, d=D, mult=2):
    """JAX's module, its params (jittered biases) and its output and
    gradients of sum(y^2) in the params and x."""
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.models.layers import MoEFeedForward as JMoE
    jdt = dict(fp32=jnp.float32, bf16=jnp.bfloat16)[dtype]
    moe = JMoE(dim=d, num_experts=e, capacity_factor=cf, mult=mult,
               dtype=jdt)
    params = seeded_params(jax.eval_shape(
        moe.init, jax.random.PRNGKey(0), jnp.asarray(x))['params'], e)

    def loss(p, xx):
        y = moe.apply({'params': p}, xx).astype(jnp.float32)
        return jnp.sum(y ** 2), y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return params, np.asarray(y), jax.device_get(gp), np.asarray(gx)


def _port_moe(params, e, cf, dtype, d=D, mult=2):
    tdt = dict(fp32=torch.float32, bf16=torch.bfloat16)[dtype]
    moe = MoEFeedForward(d, e, cf, mult=mult, dtype=tdt)
    moe.load_state_dict(jax_params_to_torch(params), strict=True)
    return moe


def _port_grads(moe, x, dtype):
    tdt = dict(fp32=torch.float32, bf16=torch.bfloat16)[dtype]
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = moe(xt)
    (y.float() ** 2).sum().backward()
    return y.float().detach().numpy(), \
        {n: p.grad.numpy() for n, p in moe.named_parameters()}, \
        xt.grad.float().numpy()


def _tokens(seed=0, b=B, s=S, d=D):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('cf', [0.5, 1.0, 2.0])
@pytest.mark.parametrize('e', [1, 2, 4])
def test_moe_forward_and_grads_match_jax(e, cf, dtype):
    x = _tokens(e)
    if max(1, int(S * cf) // e) > S:
        # more picks per expert than tokens: JAX's top_k refuses, and so
        # does the port
        with pytest.raises(ValueError, match='top_k'):
            _jax_moe(e, cf, dtype, x)
        moe = MoEFeedForward(D, e, cf, mult=2)
        with pytest.raises(ValueError, match='exceeds the 8 tokens'):
            moe(torch.from_numpy(x))
        return
    params, want, want_gp, want_gx = _jax_moe(e, cf, dtype, x)
    moe = _port_moe(params, e, cf, dtype)
    assert moe.capacity(S) == max(1, int(S * cf) // e)
    got, gp, gx = _port_grads(moe, x, dtype)
    assert set(gp) == set(want_gp) == {'router', 'w_in', 'b_in', 'w_out',
                                       'b_out'}
    if dtype == 'fp32':
        np.testing.assert_allclose(got, want, **F32_OUT)
        np.testing.assert_allclose(gx, want_gx, **F32_GRAD)
        for k in gp:
            np.testing.assert_allclose(gp[k], want_gp[k], **F32_GRAD,
                                       err_msg=k)
        return
    assert _rel_l2(got, want) <= BF16_REL_L2
    assert _rel_l2(gx, want_gx) <= BF16_REL_L2
    for k in gp:
        assert _rel_l2(gp[k], want_gp[k]) <= BF16_REL_L2, k


def test_single_expert_full_capacity_equals_dense_ffn():
    """E = 1 at capacity 1: every token through the one expert at gate 1,
    the dense ``FeedForward`` with the same weights (its kernels the
    expert's, transposed)."""
    torch.manual_seed(0)
    moe = MoEFeedForward(D, 1, 1.0, mult=4, dtype=torch.float32)
    dense = FeedForward(D, dtype=torch.float32)
    with torch.no_grad():
        moe.b_in.normal_()
        moe.b_out.normal_()
        dense.in_proj.weight.copy_(moe.w_in[0].T)
        dense.in_proj.bias.copy_(moe.b_in[0])
        dense.out_proj.weight.copy_(moe.w_out[0].T)
        dense.out_proj.bias.copy_(moe.b_out[0])
    x = torch.from_numpy(_tokens(5))
    torch.testing.assert_close(moe(x), dense(x), **F32_OUT)
    via_ff = FeedForward(D, moe_experts=1, moe_capacity_factor=1.0,
                         dtype=torch.float32)
    via_ff.moe.load_state_dict(moe.state_dict())
    assert sorted(dict(via_ff.named_parameters())) == [
        'moe.b_in', 'moe.b_out', 'moe.router', 'moe.w_in', 'moe.w_out']
    torch.testing.assert_close(via_ff(x), dense(x), **F32_OUT)


def test_expert_choice_capacity_and_passthrough():
    """C = S cf / E tokens per expert: at cf 0.5 over 4 experts of 8
    tokens one each, so at most 4 tokens get an output; the others get
    exactly 0 (the residual carries them). The capacity is JAX's integer
    arithmetic for every (S, cf, E)."""
    x = _tokens(2, b=1, d=8)
    params, want, _, _ = _jax_moe(4, 0.5, 'fp32', x, d=8)
    moe = _port_moe(params, 4, 0.5, 'fp32', d=8)
    y = moe(torch.from_numpy(x))[0]
    picked = y.norm(dim=-1) > 0
    assert 1 <= int(picked.sum()) <= 4
    assert torch.equal(y[~picked], torch.zeros_like(y[~picked]))
    np.testing.assert_allclose(y.detach().numpy(), want[0], **F32_OUT)
    for s in (1, 7, 8, 77, 4096):
        for cf in (0.25, 0.5, 1.0, 1.5, 2.0):
            for e in (1, 2, 3, 4, 8):
                m = MoEFeedForward(4, e, cf, mult=1, device='meta')
                assert m.capacity(s) == max(1, int(s * cf) // e)


def test_ties_go_to_the_lower_token_index():
    """Tokens 2 and 5 are the same vector, so every expert scores them
    alike, expert 0 above every other token; with one pick per expert (C =
    1) it takes token 2, as ``lax.top_k`` orders ties."""
    x = _tokens(3, b=1, d=8)
    params = _jax_moe(2, 0.25, 'fp32', x, d=8)[0]
    # tokens 2 and 5 alike, each expert 0's logit 4 above expert 1's, which
    # no other token comes near
    w = params['router'][:, 0] - params['router'][:, 1]
    x[0, 2] = x[0, 5] = 4.0 * w / (w @ w)
    params, want, _, _ = _jax_moe(2, 0.25, 'fp32', x, d=8)
    moe = _port_moe(params, 2, 0.25, 'fp32', d=8)
    y = moe(torch.from_numpy(x))[0].detach()
    np.testing.assert_allclose(y.numpy(), want[0], **F32_OUT)
    assert y[2].norm() > 0 and y[5].norm() == 0


# ---- the families -----------------------------------------------------------

FLUX_NET = dict(in_channels=16, num_layers=2, num_single_layers=2,
                attention_head_dim=16, num_attention_heads=4,
                joint_attention_dim=32, pooled_projection_dim=16,
                axes_dims_rope=(4, 6, 6), moe_experts=2,
                moe_capacity_factor=1.0)
QWEN_NET = dict(in_channels=16, num_layers=2, attention_head_dim=16,
                num_attention_heads=4, joint_attention_dim=32,
                axes_dims_rope=(4, 6, 6), moe_experts=2,
                moe_capacity_factor=1.0)


def family_inputs(family, seed=6):
    rng = np.random.default_rng(seed)
    f = np.float32
    inp = dict(hidden_states=rng.standard_normal((2, 8, 8, 4)).astype(f),
               t=np.array([0.7, 0.3], f),
               encoder_hidden_states=rng.standard_normal((2, 8, 32)
                                                         ).astype(f))
    if family == 'flux':
        inp.update(pooled_projections=rng.standard_normal((2, 16)).astype(f),
                   guidance=np.array([3.5, 1.0], f))
    else:
        inp['encoder_hidden_states_mask'] = np.array(
            [[1] * 6 + [0] * 2, [1] * 8], np.int32)
    return inp


def family_pair(family):
    """JAX's tiny MoE model of ``family`` (seeded params) and the port's
    with the same weights, both fp32."""
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
    from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JQwen
    inp = family_inputs(family)
    if family == 'flux':
        jm = JArcFlux(patch_size=2, num_gaussians=4, guidance_embeds=True,
                      checkpointing=False, dtype=jnp.float32, **FLUX_NET)
        tm = ArcFluxTransformer2DModel(num_gaussians=4, dtype=torch.float32,
                                       **FLUX_NET)
    else:
        jm = JQwen(patch_size=2, num_gaussians=4, checkpointing=False,
                   dtype=jnp.float32, **QWEN_NET)
        tm = ArcQwenImageTransformer2DModel(num_gaussians=4,
                                            dtype=torch.float32, **QWEN_NET)
    params = seeded_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(3), **{k: jnp.asarray(v) for k, v in
                                          inp.items()})['params'], 3)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    return jm, params, tm, inp


def jax_apply(jm, params, inp):
    import jax
    import jax.numpy as jnp
    out = jax.jit(jm.apply)({'params': params},
                            **{k: jnp.asarray(v) for k, v in inp.items()})
    return {k: np.asarray(v) for k, v in jax.device_get(out).items()}


def port_apply(tm, inp):
    with torch.no_grad():
        out = tm(**{k: torch.from_numpy(v) for k, v in inp.items()})
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_moe_families_match_jax(family):
    jm, params, tm, inp = family_pair(family)
    moe = params['joint_blocks' if family == 'flux'
                 else 'transformer_blocks']['ff_img']['moe']
    assert moe['w_in'].shape == (2, 2, 64, 256)          # (L, E, D, 4D)
    assert tuple(tm.state_dict()[
        ('joint_blocks' if family == 'flux' else 'transformer_blocks')
        + '.1.ff_txt.moe.w_out'].shape) == (2, 256, 64)
    want, got = jax_apply(jm, params, inp), port_apply(tm, inp)
    for k in ('means', 'logweights', 'loggammas'):
        np.testing.assert_allclose(got[k], want[k], **MODEL_TOL, err_msg=k)


def test_flux_single_blocks_stay_dense():
    tm = ArcFluxTransformer2DModel(num_gaussians=4, device='meta',
                                   **FLUX_NET)
    names = [n for n, _ in tm.named_parameters()]
    assert any(n.startswith('joint_blocks.0.ff_img.moe.') for n in names)
    assert any(n.startswith('joint_blocks.0.ff_txt.moe.') for n in names)
    assert not any('moe' in n for n in names if n.startswith(
        'single_blocks'))


def test_toy_moe_matches_jax():
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.models.toy import ToyArcFlowDenoiser as JToy
    from arcflow_tpu_torch.models.toy import ToyArcFlowDenoiser
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 2)).astype(np.float32)
    t = rng.uniform(0, 1000, 64).astype(np.float32)
    jm = JToy(hidden=(32, 32, 32), moe_experts=4, moe_capacity_factor=2.0,
              fourier_freqs=2)
    params = seeded_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
        jnp.asarray(t))['params'], 0)
    assert params['moe']['w_in'].shape == (4, 32, 64)
    want = jax.device_get(jax.jit(jm.apply)({'params': params},
                                            jnp.asarray(x), jnp.asarray(t)))
    tm = ToyArcFlowDenoiser(hidden=(32, 32, 32), moe_experts=4,
                            moe_capacity_factor=2.0, fourier_freqs=2,
                            data_shape=(2,), device='cpu')
    assert tm.moe_at == 1
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **F32_OUT, err_msg=k)


def test_moe_toy_config_trains_through_train_model(tmp_path):
    """``configs/toy/checkerboard_arcflow_2nfe_moe.py`` through
    ``train_model`` with its experts, capacity and routing as shipped
    (one process: the toy configs set no mesh), cut to hidden (32, 32), 64
    rows and 5 iterations from a 5-iteration flow teacher: the router and
    the experts trainable, in the checkpoint and finite."""
    from arcflow_tpu_torch import Config
    from arcflow_tpu_torch.apis import train as t_train
    from arcflow_tpu_torch.runner import load_raw_checkpoint
    toy = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'configs', 'toy')
    cut = {'data.train_dataloader.samples_per_gpu': 64, 'total_iters': 5,
           'checkpoint_config.interval': 5, 'log_config.interval': 5}
    flow = Config.fromfile(os.path.join(toy, 'checkerboard_flow.py'))
    flow.merge_from_dict(dict(cut, **{
        'model.diffusion.denoising.hidden': (32, 32)}))
    t_train.train_model(flow, str(tmp_path / 'flow'), device='cpu')
    cfg = Config.fromfile(os.path.join(toy,
                                       'checkerboard_arcflow_2nfe_moe.py'))
    cfg.merge_from_dict(dict(cut, **{
        'model.teacher_ckpt': str(tmp_path / 'flow' / 'checkpoints' /
                                  'checkerboard_flow'),
        'model.diffusion.denoising.hidden': (32, 32),
        'model.teacher.denoising.hidden': (32, 32)}))
    state, model = t_train.train_model(cfg, str(tmp_path / 'moe'),
                                       device='cpu')
    moe = model.diffusion.denoising.moe
    assert state.step == 5 and (moe.num_experts, moe.capacity(64)) == (4, 32)
    trainable = state.trainable['diffusion']
    assert tuple(trainable['moe.w_in'].shape) == (4, 32, 64)
    raw = load_raw_checkpoint(str(tmp_path / 'moe' / 'checkpoints' /
                                  cfg.name))
    assert raw['step'] == 5 and 'moe.router' in raw['trainable'][
        'diffusion']
    assert all(torch.isfinite(t).all()
               for t in raw['trainable']['diffusion'].values())


def test_toy_moe_under_a_data_mesh_is_refused_by_name():
    """The toy routes over the batch's rows; under a data mesh of 2 batch
    ranks a rank holds half of them, where JAX's GSPMD routes over the
    global batch: refused, naming the queue item."""
    from arcflow_tpu_torch.models.toy import ToyArcFlowDenoiser
    tm = ToyArcFlowDenoiser(hidden=(8, 8), moe_experts=2, data_shape=(2,),
                            device='cpu')
    x, t = torch.zeros(4, 2), torch.zeros(4)
    tm(x, t)
    with batch_rows(1, 2), pytest.raises(NotImplementedError,
                                         match='global batch.*item 5.9'):
        tm(x, t)


def test_moe_blocks_under_sp_are_refused_by_name():
    """JAX routes each expert over the whole sequence; a rank of an sp
    group holds a shard of it."""
    tm = ArcFluxTransformer2DModel(num_gaussians=4, dtype=torch.float32,
                                   **FLUX_NET)
    inp = {k: torch.from_numpy(v) for k, v in family_inputs('flux').items()}
    setup_distributed('cpu')
    try:
        set_sequence_parallel(tm, SequenceParallel(mode='ring'))
        with pytest.raises(NotImplementedError,
                           match='whole sequence.*item 5.8'):
            tm(**inp)
    finally:
        dist.destroy_process_group()


def test_distillation_freezes_the_moe_leaves_as_jax():
    """JAX's adapter (``freeze_exclude=ARCFLUX_ADAPTER_KEYS``) and the
    port's trainable set: no MoE leaf in either; the router and experts in
    the frozen trunk."""
    import importlib
    import jax
    tt = importlib.import_module('test_torch_train')
    cfg = tt.model_cfg()
    for part in ('diffusion', 'teacher'):
        cfg[part]['denoising'].update(moe_experts=2)
    jtr, jfr = jax.eval_shape(tt.jax_model(cfg).init_params,
                              jax.random.PRNGKey(0))
    trainable, frozen = tt.port_model(cfg).init_params()
    want = set(jax_params_to_torch(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jtr['diffusion'])))
    assert set(trainable['diffusion']) == want
    assert not any('moe' in n for n in want)
    assert 'joint_blocks.0.ff_img.moe.router' in frozen['base']


# ---- expert parallelism -----------------------------------------------------

EP_E, EP_D, EP_S = 4, 32, 16


def test_expert_ownership_follows_jax_specs():
    """The expert dim of each leaf goes to ``expert`` (the port's expert
    slices), the layer dim to ``pipe``, the rest by the TP / FSDP rule:
    the port's spec functions against JAX's on the same shapes."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    from arcflow_tpu.parallel import moe_param_spec as j_moe
    from arcflow_tpu.parallel import param_spec_for_path as j_path
    cases = [((8, 256, 512), dict(fsdp_axis='fsdp', fsdp_size=2,
                                  tensor_axis='tensor', tensor_size=2)),
             ((4, 8, 256, 512), dict(stacked=True, pipe_axis='pipe',
                                     pipe_size=2, fsdp_axis='fsdp',
                                     fsdp_size=2)),
             ((3, 64, 64), {}), ((2, 2, 64, 256), dict(stacked=True)),
             ((64, 4), {}), ((4, 256), {})]
    for shape, kw in cases:
        for n in (1, 2, 4):
            want = j_moe(jnp.zeros(shape), 'expert', n, min_size=1024, **kw)
            got = moe_param_spec(shape, 'expert', n, min_size=1024, **kw)
            assert tuple(want) == got, (shape, n, kw)
    mesh = j_make_mesh({'pipe': 2, 'expert': 2, 'data': 2})
    sizes = dict(mesh.shape)
    for path, shape in [('joint_blocks/ff_img/moe/w_in', (2, 2, 64, 256)),
                        ('joint_blocks/ff_img/moe/router', (2, 64, 2)),
                        ('moe/b_out', (4, 32)),
                        ('single_blocks/proj_mlp/kernel', (2, 64, 256)),
                        ('x_embedder/kernel', (16, 64))]:
        want = j_path(path, jnp.zeros(shape), mesh, min_size=256)
        assert tuple(want) == param_spec_for_path(path, shape, sizes,
                                                  min_size=256), path
    assert tuple(P('pipe', 'expert', None, None)) == param_spec_for_path(
        'joint_blocks/ff_img/moe/w_in', (2, 2, 64, 256), sizes,
        min_size=256)


def ep_on_rank(inputs):
    """This rank's part of the EP check (run in the 4-rank spawn of
    ``tests/test_torch_pipeline_parallel.py``, which holds the test):
    expert=2 x data=2, each rank 2 of 4 experts and 1 of 2 rows."""
    mesh = make_mesh({'expert': 2, 'data': 2})
    ep = ExpertParallel(mesh.get_group('expert'))
    moe = MoEFeedForward(EP_D, EP_E, 1.0, mult=2, dtype=torch.float32)
    moe.load_state_dict(jax_params_to_torch(inputs['params']), strict=True)
    moe.partition_experts(ep)
    index, count = batch_ranks(mesh)
    x = torch.from_numpy(inputs['x'])
    rows = x.shape[0] // count
    xt = x[index * rows:(index + 1) * rows].clone().requires_grad_()
    y = moe(xt)
    (y ** 2).sum().backward()
    return dict(index=index, experts=ep.experts(EP_E), y=y.detach(),
                gx=xt.grad,
                grads={n: p.grad for n, p in moe.named_parameters()},
                shapes={n: tuple(p.shape) for n, p in moe.named_parameters()})


def ep_inputs():
    """The EP check's inputs and JAX's single-device output and
    gradients."""
    x = _tokens(9, b=2, s=EP_S, d=EP_D)
    params, want, want_gp, want_gx = _jax_moe(EP_E, 1.0, 'fp32', x, d=EP_D)
    return dict(params=params, x=x), (want, want_gp, want_gx)


def check_ep(ranks, want):
    """Each rank's rows and experts against JAX: the outputs and the
    input's gradients by row, the experts' gradients summed over the data
    ranks, the router's the same on both ranks of an expert group."""
    want, want_gp, want_gx = want
    gp = {k: np.zeros_like(v) for k, v in want_gp.items()}
    for r in ranks:
        lo, hi = r['experts']
        assert r['shapes']['w_in'] == (hi - lo, EP_D, 2 * EP_D)
        assert r['shapes']['router'] == (EP_D, EP_E)
        i = r['index']
        np.testing.assert_allclose(r['y'].numpy(), want[i:i + 1], **EP_OUT)
        np.testing.assert_allclose(r['gx'].numpy(), want_gx[i:i + 1],
                                   **EP_GRAD)
        for k, g in r['grads'].items():
            if k != 'router':
                gp[k][lo:hi] += g.numpy()
    by_index = {r['index']: r['grads']['router'].numpy() for r in ranks}
    for r in ranks:
        np.testing.assert_array_equal(r['grads']['router'].numpy(),
                                      by_index[r['index']])
    gp['router'] = sum(by_index.values())
    for k in gp:
        np.testing.assert_allclose(gp[k], want_gp[k], **EP_GRAD, err_msg=k)
