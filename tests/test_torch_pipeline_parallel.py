"""Port parity for pipeline parallelism over the ``pipe`` axis
(``parallel/pipeline.py``: the GPipe and circular schedules), and for
training on ``pipe`` and ``expert`` ranks (``parallel/model_parallel.py``),
against the JAX package on the CPU.

* The microbatch count, the partition and the stage that holds each layer
  against JAX's ``_pick_microbatches``, ``pipe_partition`` and the layer
  placement of its ``pipeline_scan`` (read from JAX's own schedule: each
  layer records the stage that runs it), V degrading to 1 unless M == S
  and L % (S V) == 0.
* The schedule on ``LocalPipe(S)`` for S in {2, 4}, M in {1, 2, 4}, V in
  {1, 2}, forward and gradients (of the layers, the carry and a per-sample
  input that rides the microbatches) against the plain loop, and against
  JAX's ``pipeline_scan`` on its simulated mesh: rtol 1e-5, atol 1e-5 (JAX's
  ``tests/test_pipeline.py`` bound is 1e-4 on the gradients).
* Tiny ArcFlux (the (img, txt) tuple carry, the ControlNet residuals
  riding) and ArcQwen (the text key mask riding) with their stacks on
  ``LocalPipe(2)`` against JAX's unpipelined ``apply`` (rtol 2e-3, atol
  2e-4, JAX's pipeline-test bound), and their outputs and gradients, LoRA
  dropout on, against the port's plain loop (outputs rtol 1e-5, atol 1e-6;
  each gradient within 1e-5 relative L2: a weight's gradient sums the
  microbatches' parts, fp32 sums in another order); the int8 trunk so.
* Training steps on 4 gloo ranks: the tiny ArcFlux distillation of
  ``tests/test_torch_mesh_train.py`` with ``moe_experts=2`` at ``data=2 x
  pipe=2`` (its 2 single blocks staged, its joint block plain, the experts
  whole) and at ``pipe=2 x expert=2`` (the experts split), with JAX's
  draws replayed and dropout off (one JAX reference, at one intermediate
  state and no CFG on the teacher: each costs many seconds of compile),
  against JAX's single-device ``value_and_grad``, optax's AdamW and the
  JAX EMA (``tests/test_torch_mesh_train.py``'s bounds: loss 1e-4; the
  gradient norm and each adapter tensor's update 1e-3 relative L2; the EMA
  rtol 1e-5, atol 1e-7); with LoRA dropout and checkpointing, the dense
  and the MoE model in both layouts against the port's one-process step
  (loss rtol 1e-5, updates 1e-4). Every rank
  holds only its stage's blocks and its experts, the replicated tensors
  equal on every rank.
* The tiny ArcQwen distillation (2 blocks, the text key mask riding) at
  ``data=2 x pipe=2`` with dropout against the port's one-process step.
* ``tests/test_torch_moe.py``'s expert-parallel check (``expert=2 x
  data=2``) runs in the same spawn.
* ``train_model`` on ``configs/flux/arcflux_2nfe_k16.py`` with
  ``configs/flux/_pipeline_train.py`` composed in (``fsdp_axis=None``,
  ``mesh=dict(data=-1, pipe=2)``) at the tiny width on 4 ranks: its
  checkpoint is the live state in the one-device layout, bit for bit, and
  resumes with no mesh.
* JAX's pipelined dropout would fold the layer index into its key, which
  its scan splits, and with the installed JAX it does not trace at all
  (the divergence the port does not copy: its pipelined dropout is its
  one-device dropout).

JAX runs only in this process; the rank function lives at module level
and the module imports JAX only inside functions.
"""

import copy
import importlib
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from arcflow_tpu_torch import Config
from arcflow_tpu_torch.models import (ArcFluxTransformer2DModel,
                                      ArcQwenImageTransformer2DModel,
                                      LatentDiffusionTextImage)
from arcflow_tpu_torch.parallel import (LocalPipe, make_mesh,
                                        partition_model, pipeline_run,
                                        set_pipe, setup_distributed, spawn)
from arcflow_tpu_torch.parallel.mesh import batch_ranks
from arcflow_tpu_torch.parallel.pipeline import (layer_stage,
                                                 pick_microbatches,
                                                 pipe_partition)
from arcflow_tpu_torch.pipelines import (jax_params_to_torch,
                                         load_jax_latent_diffusion)
from arcflow_tpu_torch.runner import (EmaConfig, TrainState,
                                      build_optimizers, build_train_step,
                                      load_raw_checkpoint)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
PLAIN_TOL = dict(rtol=1e-5, atol=1e-6)
PLAIN_GRAD_REL_L2 = 1e-5
LOSS_RTOL, REL_L2 = 1e-4, 1e-3
EMA_TOL = dict(rtol=1e-5, atol=1e-7)
EMA_MOMENTUM = 0.9
OPTIMIZER = dict(diffusion=dict(type='AdamW', lr=1e-3, betas=(0.9, 0.95),
                                eps=1e-2, weight_decay=0.0))
RANKS, GLOBAL_BS = 4, 4
# the mesh and the MoE model's ('moe') or the dense one's ('flux') weights
LAYOUTS = {'data2_pipe2': dict(data=2, pipe=2),
           'pipe2_expert2': dict(pipe=2, expert=2)}
CKB_ITERS = 2


# ---- the schedule -----------------------------------------------------------

def _toy_layer(w, x, rider):
    return torch.tanh(x @ w) + x + rider


def _toy_stack(l=8, d=16, b=8, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.2 * rng.standard_normal((l, d, d))).astype(np.float32)
    x = rng.standard_normal((b, d)).astype(np.float32)
    rider = (0.1 * rng.standard_normal((b, d))).astype(np.float32)
    return w, x, rider


def _port_run(w, x, rider, pipe):
    ws = [torch.tensor(wi, requires_grad=True) for wi in w]
    xt = torch.tensor(x, requires_grad=True)
    rt = torch.tensor(rider, requires_grad=True)

    def layer(i, carry, riders):
        return (_toy_layer(ws[i], carry[0], riders[0]),)
    if pipe is None:
        out = (xt,)
        for i in range(len(ws)):
            out = layer(i, out, (rt,))
    else:
        out = pipeline_run(layer, len(ws), (xt,), (rt,), pipe, params=ws)
    (out[0] ** 2).sum().backward()
    return [out[0].detach().numpy(), xt.grad.numpy(), rt.grad.numpy(),
            np.stack([wi.grad.numpy() for wi in ws])]


def test_microbatches_and_partition_match_jax():
    import jax
    from arcflow_tpu.parallel import activation_sharding
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    from arcflow_tpu.parallel import pipe_partition as j_partition
    from arcflow_tpu.parallel.pipeline import _pick_microbatches
    for b in range(1, 9):
        for s in (1, 2, 3, 4):
            for req in (None, 1, 2, 3, 4, 8):
                assert pick_microbatches(b, s, req) == \
                    _pick_microbatches(b, s, req)
    for s in (2, 4):
        mesh = j_make_mesh({'pipe': s, 'data': 8 // s})
        for v in (1, 2, 3):
            for micro in (None, 2):
                with activation_sharding(mesh, pipe_microbatches=micro,
                                         pipe_interleave=v):
                    for n in (2, 3, 4, 8, 12, 19, 38, 60):
                        want = j_partition(n, 4)
                        got = pipe_partition(LocalPipe(s, micro, v), n, 4)
                        assert (want is None) == (got is None), (s, v, n)
                        if got is None:
                            continue
                        assert want[2] == micro and got[0] == s
                        m = pick_microbatches(4, s, micro)
                        assert got[1] == m
                        assert got[2] == (want[3] if m == s else 1)
    assert jax.device_count() == 8


def _jax_stage_of_layers(l, s, v):
    """The stage JAX's ``pipeline_scan`` runs each of ``l`` layers on:
    layer i adds (its stage + 1) at column i of the carry."""
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.parallel import activation_sharding, pipeline_scan
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    mesh = j_make_mesh({'pipe': s, 'data': 8 // s})

    def apply_layer(lvars, c, bc, li):
        stage = jax.lax.axis_index('pipe')
        return c + jax.nn.one_hot(li, l) * (stage + 1) + 0 * lvars['w']
    with activation_sharding(mesh, batch_axes=('data',)):
        out = jax.jit(lambda sv, c: pipeline_scan(
            apply_layer, sv, c, jnp.float32(0), mesh, 'pipe',
            microbatches=s, interleave=v))({'w': jnp.zeros((l, 1))},
                                           jnp.zeros((s, l)))
    return np.asarray(out)[0].astype(int) - 1


@pytest.mark.parametrize('s, v', [(2, 1), (2, 2), (2, 4), (4, 1), (4, 2)])
def test_layer_stage_is_jax_placement(s, v):
    want = _jax_stage_of_layers(8, s, v)
    assert [layer_stage(i, 8, s, v) for i in range(8)] == want.tolist()


@pytest.mark.parametrize('v', [1, 2])
@pytest.mark.parametrize('m', [1, 2, 4])
@pytest.mark.parametrize('s', [2, 4])
def test_local_pipe_matches_plain_loop(s, m, v):
    """Forward and gradients; V = 2 runs circular only at M == S (and L %
    (S V) == 0), else as GPipe, as in JAX."""
    w, x, rider = _toy_stack()
    want = _port_run(w, x, rider, None)
    got = _port_run(w, x, rider, LocalPipe(s, m, v))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, **SCHED_TOL)
    assert pipe_partition(LocalPipe(s, m, v), 8, 8)[2] == \
        (v if m == s else 1)


def test_local_pipe_matches_jax_pipeline_scan():
    """The circular schedule (S = 2, V = 2, M = 2) against JAX's on its
    simulated mesh, forward and the layers' gradients."""
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.parallel import activation_sharding, pipeline_scan
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    w, x, rider = _toy_stack(b=4)
    mesh = j_make_mesh({'pipe': 2, 'data': 4})

    def layer(lvars, c, bc, li):
        return jnp.tanh(c @ lvars['w']) + c + bc

    def loss(sv, c, bc):
        out = pipeline_scan(layer, sv, c, bc, mesh, 'pipe', microbatches=2,
                            interleave=2)
        return jnp.sum(out ** 2), out
    with activation_sharding(mesh, batch_axes=('data',)):
        # a batch-free rider: JAX's broadcast input
        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            {'w': jnp.asarray(w)}, jnp.asarray(x),
            jnp.asarray(rider[0]))
    got = _port_run(w, x, np.broadcast_to(rider[0], rider.shape).copy(),
                    LocalPipe(2, 2, 2))
    np.testing.assert_allclose(got[0], np.asarray(out), **SCHED_TOL)
    np.testing.assert_allclose(got[3], np.asarray(g['w']), rtol=1e-4,
                               atol=1e-4)


# ---- the families on LocalPipe ----------------------------------------------

def _family(family, **extra):
    tm_ = importlib.import_module('test_torch_moe')
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
    from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JQwen
    net = dict(tm_.FLUX_NET if family == 'flux' else tm_.QWEN_NET,
               lora_rank=4)
    net.update(dict(moe_experts=0), **extra)
    inp = tm_.family_inputs(family)
    if family == 'flux':
        jm = JArcFlux(patch_size=2, num_gaussians=4, guidance_embeds=True,
                      checkpointing=False, dtype=jnp.float32, **net)
        tm = ArcFluxTransformer2DModel(num_gaussians=4, dtype=torch.float32,
                                       **net)
    else:
        jm = JQwen(patch_size=2, num_gaussians=4, checkpointing=False,
                   dtype=jnp.float32, **net)
        tm = ArcQwenImageTransformer2DModel(num_gaussians=4,
                                            dtype=torch.float32, **net)
    params = tm_.seeded_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(3),
        **{k: jnp.asarray(v) for k, v in inp.items()})['params'], 5)
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    return tm_, jm, params, tm, inp


def _same_as_plain(piped, plain):
    (out, grads), (want_out, want_grads) = piped, plain
    for k in want_out:
        np.testing.assert_allclose(out[k], want_out[k], **PLAIN_TOL,
                                   err_msg=k)
    assert grads.keys() == want_grads.keys() and grads
    for k in want_grads:
        assert _rel_l2(grads[k], want_grads[k]) <= PLAIN_GRAD_REL_L2, k


def _port_out_and_grads(tm, inp, pipe, seed=None, **kw):
    set_pipe(tm, pipe)
    tm.zero_grad()
    out = tm(**{k: torch.from_numpy(v) for k, v in inp.items()},
             dropout_seed=seed, **kw)
    sum((v ** 2).sum() for v in out.values()).backward()
    set_pipe(tm, None)
    return ({k: v.detach().numpy() for k, v in out.items()},
            {n: p.grad.numpy() for n, p in tm.named_parameters()
             if p.grad is not None})


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_pipelined_family_matches_jax_and_its_plain_loop(family):
    """The stacks on LocalPipe(2) at M = 2 (the FLUX img / txt tuple
    carry; Qwen's key mask riding): outputs against JAX's apply, outputs
    and gradients, LoRA dropout on, against the plain loop."""
    tm_, jm, params, tm, inp = _family(family, lora_dropout=0.1)
    want = tm_.jax_apply(jm, params, inp)
    got, _ = _port_out_and_grads(tm, inp, LocalPipe(2, 2))
    for k in ('means', 'logweights', 'loggammas'):
        np.testing.assert_allclose(got[k], want[k], **MODEL_TOL, err_msg=k)
    _same_as_plain(_port_out_and_grads(tm, inp, LocalPipe(2, 2), seed=3),
                   _port_out_and_grads(tm, inp, None, seed=3))


def test_moe_blocks_in_a_pipelined_stage_match_jax():
    """JAX's ``test_moe_composes_with_pipeline`` in one process: the 2 MoE
    joint blocks staged on LocalPipe(2), against JAX's apply."""
    tm_, jm, params, tm, inp = _family('flux', moe_experts=2)
    assert pipe_partition(LocalPipe(2), len(tm.joint_blocks), 2) is not None
    want = tm_.jax_apply(jm, params, inp)
    got, _ = _port_out_and_grads(tm, inp, LocalPipe(2, 2))
    for k in ('means', 'logweights', 'loggammas'):
        np.testing.assert_allclose(got[k], want[k], **MODEL_TOL, err_msg=k)


def test_controlnet_residuals_ride_the_microbatches():
    """JAX runs a stack with ControlNet residuals as a plain scan
    (``_apply_stacked_blocks`` is bypassed); the port pipelines it, each
    block's residual riding: the same output as its plain loop."""
    _, _, _, tm, inp = _family('flux')
    rng = np.random.default_rng(2)
    cn = dict(controlnet_block_samples=[torch.from_numpy(
        rng.standard_normal((2, 16, 64)).astype(np.float32))],
        controlnet_single_block_samples=[torch.from_numpy(
            rng.standard_normal((2, 16, 64)).astype(np.float32))
            for _ in range(2)])
    _same_as_plain(_port_out_and_grads(tm, inp, LocalPipe(2, 2), **cn),
                   _port_out_and_grads(tm, inp, None, **cn))


def test_int8_trunk_pipelines_with_its_buffers():
    from arcflow_tpu_torch.utils.quantize import quantize_weights_int8
    _, _, _, tm, inp = _family('qwen')
    quantize_weights_int8(tm, min_size=256)
    assert any(n.endswith('.kernel') for n, _ in tm.named_buffers())
    _same_as_plain(_port_out_and_grads(tm, inp, LocalPipe(2, 1)),
                   _port_out_and_grads(tm, inp, None))


def test_jax_pipelined_dropout_fails_where_the_port_keeps_its_masks():
    """The divergence: JAX's stage body would draw layer li's dropout from
    ``fold_in(key, li)`` where its ``nn.scan`` splits the key, so its
    pipelined masks are not its scan's; with the installed JAX the stage
    body's dropout does not even trace (flax's ``Dropout`` broadcasts
    under the manual ``pipe`` axis against an auto mesh). The port draws
    a pipelined block's masks from its per-row generators, the one-device
    masks (``test_pipelined_family_matches_jax_and_its_plain_loop``)."""
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.parallel import activation_sharding
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    _, jm, params, _, inp = _family('flux', lora_dropout=0.5)
    kw = {k: jnp.asarray(v) for k, v in inp.items()}

    def apply(rngs):        # a new function each call: no cached trace
        return jax.jit(lambda p: jm.apply({'params': p}, rngs=rngs,
                                          **kw)['means'])
    drop = {'dropout': jax.random.PRNGKey(9)}
    assert np.isfinite(np.asarray(apply(drop)(params))).all()   # its scan
    with activation_sharding(j_make_mesh({'pipe': 2, 'data': 4}),
                             batch_axes=('data',)), \
            pytest.raises(ValueError, match='Context mesh .*Manual'):
        apply(drop)(params)


# ---- training on pipe and expert ranks --------------------------------------

def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _rows(tree, index, count):
    def rows(x):
        n = len(x) // count
        return torch.from_numpy(np.ascontiguousarray(x[index * n:
                                                       (index + 1) * n]))
    return _map(rows, tree)


def _gathered(state, mp):
    """The adapter and its EMA in the one-device layout, on rank 0 (this
    rank's tensors without a placement)."""
    def full(tree):
        if mp is None:
            return {n: t.detach().clone() for n, t in tree.items()}
        return {n: mp.gather_full(n, t.detach()) for n, t in tree.items()}
    return full(state.trainable['diffusion']), full(state.ema['diffusion'])


def pipe_step(inputs, mesh, variant):
    """One ``build_train_step`` step of the tiny distillation on ``mesh``
    (None: one process): 'replay' with JAX's draws and no dropout,
    'dropout' with LoRA dropout and checkpointing."""
    cfg = inputs['cfg' if variant == 'replay' else 'cfg_dropout']
    model = LatentDiffusionTextImage(device='cpu', dtype=torch.float32,
                                     **copy.deepcopy(cfg))
    load_jax_latent_diffusion(model, inputs['trainable'], inputs['frozen'])
    before = {n: t.detach().clone() for n, t in
              model.init_params()[0]['diffusion'].items()}
    mp = partition_model(model, mesh) if mesh is not None else None
    index, count = batch_ranks(mesh) if mesh is not None else (0, 1)
    trainable, frozen = model.init_params()
    optimizers = build_optimizers(copy.deepcopy(OPTIMIZER), trainable)
    state = TrainState.create(torch.Generator().manual_seed(11), trainable,
                              frozen, optimizers, ema_keys=model.ema_keys)
    state.model_parallel = mp
    step = build_train_step(
        model, optimizers,
        ema_cfg=EmaConfig(momentum_policy='fixed', momentum=EMA_MOMENTUM),
        mesh=mesh)
    batch = _rows(inputs['batch'], index, count)
    if variant == 'replay':
        tmt = importlib.import_module('test_torch_mesh_train')
        rand, randn, rest = tmt._replaying(inputs['draws'])
        with mock.patch.object(torch, 'rand', rand), \
                mock.patch.object(torch, 'randn', randn):
            state, logs = step(state, batch)
        assert next(rest, None) is None
    else:
        state, logs = step(state, batch)
    adapter, ema = _gathered(state, mp)
    den = model.diffusion.denoising
    return dict(loss=float(logs['loss']),
                gnorm=float(logs['diffusion_grad_norm']), before=before,
                adapter=adapter, ema=ema,
                held={n: tuple(t.shape) for n, t in den.state_dict().items()},
                replicated={n: t.detach().clone() for n, t in
                            den.state_dict().items()
                            if mp is not None and mp.place(n).stage is None
                            and not mp.place(n).expert})


def qwen_pipe_step(inputs, mesh):
    """One step of ``tests/test_torch_qwen_train.py``'s tiny ArcQwen
    distillation at 2 blocks (its 2 blocks staged at pipe=2, the text key
    mask riding), LoRA dropout and checkpointing on, every weight drawn
    from a seeded generator, on ``mesh`` (None: one process): (loss,
    gradient norm, the adapter in the one-device layout on rank 0)."""
    with torch.random.fork_rng():       # its init draws alike everywhere
        torch.manual_seed(0)
        model = LatentDiffusionTextImage(device='cpu', dtype=torch.float32,
                                         **copy.deepcopy(inputs['cfg']))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.diffusion.denoising.parameters():
            p.copy_(p + 0.05 * torch.randn(p.shape, generator=g))
    mp = partition_model(model, mesh) if mesh is not None else None
    index, count = batch_ranks(mesh) if mesh is not None else (0, 1)
    trainable, frozen = model.init_params()
    optimizers = build_optimizers(copy.deepcopy(OPTIMIZER), trainable)
    state = TrainState.create(torch.Generator().manual_seed(11), trainable,
                              frozen, optimizers, ema_keys=model.ema_keys)
    state.model_parallel = mp
    step = build_train_step(
        model, optimizers,
        ema_cfg=EmaConfig(momentum_policy='fixed', momentum=EMA_MOMENTUM),
        mesh=mesh)
    state, logs = step(state, _rows(inputs['batch'], index, count))
    return dict(loss=float(logs['loss']),
                gnorm=float(logs['diffusion_grad_norm']),
                adapter=_gathered(state, mp)[0])


def pipeline_cfg(tmp):
    """``configs/flux/arcflux_2nfe_k16.py`` with ``_pipeline_train.py``'s
    ``parallel`` composed in, at the tiny width, its data the records of
    ``tests/test_torch_eval_test_set.py``."""
    tev = importlib.import_module('test_torch_eval_test_set')
    cfg = Config.fromfile(os.path.join(REPO, 'configs/flux/'
                                       'arcflux_2nfe_k16.py'))
    fragment = Config.fromfile(os.path.join(REPO, 'configs/flux/'
                                            '_pipeline_train.py'))
    opts = {f'model.diffusion.denoising.{k}': v for k, v in tev.NET.items()}
    opts.update({f'model.teacher.denoising.{k}': v
                 for k, v in tev.NET.items()})
    opts['model.diffusion.denoising.num_single_layers'] = 2
    opts['model.teacher.denoising.num_single_layers'] = 2
    opts.update({'model.diffusion.denoising.lora_rank': 4,
                 'model.text_embed_dim': 32, 'model.pooled_dim': 16,
                 'model.latent_shape': tev.LATENT,
                 'parallel': dict(fragment.parallel, _delete_=True),
                 'data.train.cache_dir': os.path.join(tmp, 'preproc_flux'),
                 'data.train.datalist_path': os.path.join(
                     tmp, 'preproc_flux.jsonl.gz'),
                 'data.train.latent_size': tev.LATENT,
                 'data.train.pad_seq_len': None, 'data.train.end_ind': None,
                 'data.train_dataloader.samples_per_gpu': 1,
                 'checkpoint_config.interval': CKB_ITERS,
                 'checkpoint_config.out_dir': os.path.join(tmp, 'ckpt')})
    cfg.merge_from_dict(opts)
    return cfg


def _rank_main(tmp):
    torch.set_num_threads(1)
    setup_distributed('cpu', timeout=60.0)
    inputs = torch.load(os.path.join(tmp, 'inputs.pt'), weights_only=False)
    out = {}
    for layout, axes in LAYOUTS.items():
        mesh = make_mesh(dict(axes))
        out[layout, 'replay'] = pipe_step(inputs['moe'], mesh, 'replay')
        for name in ('flux', 'moe'):
            out[layout, name, 'dropout'] = pipe_step(inputs[name], mesh,
                                                     'dropout')
    out['qwen'] = qwen_pipe_step(inputs['qwen'],
                                 make_mesh(dict(data=2, pipe=2)))
    out['ep'] = importlib.import_module('test_torch_moe').ep_on_rank(
        inputs['ep'])
    # the circular schedule's blocks are placed for M == S: another batch
    # would move them
    mesh = make_mesh(dict(data=2, pipe=2))
    cfg = copy.deepcopy(inputs['flux']['cfg'])
    for part in ('diffusion', 'teacher'):
        cfg[part]['denoising']['num_single_layers'] = 4
    model = LatentDiffusionTextImage(device='cpu', dtype=torch.float32, **cfg)
    partition_model(model, mesh, microbatches=1, interleave=2)
    try:
        model.loss(_rows(inputs['flux']['batch'], *batch_ranks(mesh)),
                   torch.Generator().manual_seed(0),
                   running_status=dict(iteration=0))
        out['refused'] = None
    except NotImplementedError as e:
        out['refused'] = str(e)
    try:
        partition_model(model, make_mesh(dict(fsdp=2, pipe=2)))
        out['fsdp_refused'] = None
    except NotImplementedError as e:
        out['fsdp_refused'] = str(e)
    from arcflow_tpu_torch.apis import train as t_train
    state, _ = t_train.train_model(pipeline_cfg(tmp), os.path.join(tmp, 'w'),
                                   device='cpu', max_iters=CKB_ITERS)
    out['ckb'] = _gathered(state, state.model_parallel)
    out['ckb_mesh'] = dict(zip(state.model_parallel.mesh.mesh_dim_names,
                               state.model_parallel.mesh.shape))
    torch.save(out, os.path.join(tmp, f'rank{dist.get_rank()}.pt'))
    dist.destroy_process_group()


def step_cfg(**net):
    """``tests/test_torch_mesh_train.py``'s tiny distillation with one
    intermediate state and no CFG on the teacher (the JAX loss's cost is
    in its teacher calls; the layouts do not touch them), ``net`` set on
    both denoisers."""
    cfg = importlib.import_module('test_torch_mesh_train').arcflux_cfg()
    cfg['train_cfg'].update(num_intermediate_states=1,
                            teacher_guidance_scale=1.0)
    for part in ('diffusion', 'teacher'):
        cfg[part]['denoising'].update(net)
    return cfg


def _jax_pair(tt, cfg):
    """JAX's (trainable, frozen) of ``cfg``, seeded from numpy
    (``tests/test_torch_moe.py:seeded_params``; JAX's init is costly to
    compile)."""
    import jax
    tm_ = importlib.import_module('test_torch_moe')
    trainable, frozen = jax.eval_shape(tt.jax_model(cfg).init_params,
                                       jax.random.PRNGKey(1))
    return tm_.seeded_params(trainable, 7), tm_.seeded_params(frozen, 8)


def _jax_reference(tt, tq, tsp, cfg):
    import jax
    tmt = importlib.import_module('test_torch_mesh_train')
    jm = tt.jax_model(cfg)
    trainable, frozen = _jax_pair(tt, cfg)
    batch = tmt.arcflux_batch(rows=GLOBAL_BS)
    with mock.patch.object(tt, 'jax_model', lambda c: jm), \
            mock.patch.object(jm.diffusion, 'pred',
                              tq._jitted_pred(jm.diffusion)), \
            mock.patch.object(jm.teacher, 'pred',
                              tq._jitted_pred(jm.teacher)):
        ref, draws = tsp._jax_reference(tt._jax_loss_and_grads, cfg,
                                        trainable, frozen, batch)
    return ref, dict(cfg=cfg, cfg_dropout=tsp._with_dropout(cfg),
                     trainable=trainable, frozen=frozen, batch=batch,
                     draws=draws)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    tt = importlib.import_module('test_torch_train')
    tq = importlib.import_module('test_torch_qwen_train')
    tsp = importlib.import_module('test_torch_sp_train')
    tmt = importlib.import_module('test_torch_mesh_train')
    tev = importlib.import_module('test_torch_eval_test_set')
    tmp = str(tmp_path_factory.mktemp('pipe'))
    res = {}
    # one JAX reference (each costs many seconds of compile): the MoE
    # model, which data=2 x pipe=2 runs with its experts whole
    cfg = step_cfg(moe_experts=2)
    res['moe'], moe = _jax_reference(tt, tq, tsp, cfg)
    dense = dict(moe, cfg=step_cfg(), cfg_dropout=tsp._with_dropout(
        step_cfg()))
    dense['trainable'], dense['frozen'] = _jax_pair(tt, dense['cfg'])
    qwen_cfg = tq.model_cfg(num_layers=2, checkpointing=True)
    qwen_cfg['diffusion']['denoising']['lora_dropout'] = 0.1
    qwen = dict(cfg=qwen_cfg, batch=tq.make_batch(bs=GLOBAL_BS))
    ep, res['ep_want'] = importlib.import_module('test_torch_moe').ep_inputs()
    torch.save(dict(moe=moe, flux=dense, qwen=qwen, ep=ep),
               os.path.join(tmp, 'inputs.pt'))
    for name, inp in (('moe', moe), ('flux', dense)):
        res[name, 'one_dropout'] = pipe_step(inp, None, 'dropout')
    res['qwen_one'] = qwen_pipe_step(qwen, None)
    tev.write_test_set(tmp)
    spawn(_rank_main, RANKS, (tmp,), timeout=60.0)
    res['ranks'] = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                               weights_only=False) for r in range(RANKS)]
    cfg = pipeline_cfg(tmp)
    res['ckb_dir'] = os.path.join(tmp, 'ckpt', cfg.name)
    # one process, no mesh: resume the 4 ranks' checkpoint, one more step
    cfg.merge_from_dict({'parallel': dict(_delete_=True)})
    from arcflow_tpu_torch.apis import train as t_train
    with mock.patch.object(t_train.IterBasedRunner, 'run',
                           lambda self: self.state):
        state, _ = t_train.train_model(cfg, os.path.join(tmp, 'w1'),
                                       device='cpu', max_iters=CKB_ITERS)
    res['resumed'] = _gathered(state, None), state.step
    return res


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_pipe_expert_step_matches_jax_single_device(run, layout):
    want = run['moe']
    got = run['ranks'][0][layout, 'replay']
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got['gnorm'], want['gnorm'], rtol=REL_L2)
    assert set(got['adapter']) == set(want['adapter'])
    for n, p in got['adapter'].items():
        before = got['before'][n].numpy()
        err = _rel_l2(p.numpy() - before, want['adapter'][n].numpy() - before)
        assert err <= REL_L2, (n, err)
        np.testing.assert_allclose(got['ema'][n].numpy(),
                                   want['ema'][n].numpy(), **EMA_TOL)


@pytest.mark.parametrize('name', ['flux', 'moe'])
@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_pipe_expert_step_with_dropout_is_the_one_process_step(run, layout,
                                                               name):
    want = run[name, 'one_dropout']
    for r in run['ranks']:
        got = r[layout, name, 'dropout']
        np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
        np.testing.assert_allclose(got['gnorm'], want['gnorm'], rtol=1e-4)
    got = run['ranks'][0][layout, name, 'dropout']
    for n, p in got['adapter'].items():
        before = want['before'][n].numpy()
        assert _rel_l2(p.numpy() - before,
                       want['adapter'][n].numpy() - before) <= 1e-4, n


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_ranks_hold_their_stages_and_experts_only(run, layout):
    """At pipe=2 a rank holds one of the 2 single blocks (the other's
    tensors empty) and the joint block (1 block: not staged); at expert=2
    each MoE leaf 1 of its 2 experts, else both; the router whole.
    Replicated tensors are equal on every rank, bit for bit."""
    axes = LAYOUTS[layout]
    ranks = run['ranks']
    for rank, r in enumerate(ranks):
        held = r[layout, 'replay']['held']
        stage = rank % 2 if axes.get('expert') is None else rank // 2
        for i in range(2):
            shape = held[f'single_blocks.{i}.proj_mlp.weight']
            assert (shape == (0,)) == (i != stage), (rank, i, shape)
        assert held['joint_blocks.0.attn.img_q.weight'] != (0,)
        assert held['joint_blocks.0.ff_img.moe.w_in'][0] == \
            (1 if 'expert' in axes else 2)
        assert held['joint_blocks.0.ff_img.moe.router'] == (64, 2)
        rep = r[layout, 'replay']['replicated']
        for n, t in ranks[0][layout, 'replay']['replicated'].items():
            assert torch.equal(rep[n], t), (rank, n)


def test_expert_parallel_matches_single_device_jax(run):
    """``tests/test_torch_moe.py``'s EP check: ``MoEFeedForward`` at
    expert=2 x data=2 on the 4 ranks against single-device JAX."""
    importlib.import_module('test_torch_moe').check_ep(
        [r['ep'] for r in run['ranks']], run['ep_want'])


def test_qwen_step_on_data_and_pipe_ranks_is_the_one_process_step(run):
    """The tiny ArcQwen distillation (2 blocks, both staged at pipe=2, the
    text key mask and temb riding the microbatches), LoRA dropout on, at
    data=2 x pipe=2: the one-process step's loss, norm and update."""
    want = run['qwen_one']
    for r in run['ranks']:
        np.testing.assert_allclose(r['qwen']['loss'], want['loss'],
                                   rtol=1e-5)
        np.testing.assert_allclose(r['qwen']['gnorm'], want['gnorm'],
                                   rtol=1e-4)
    got = run['ranks'][0]['qwen']['adapter']
    assert set(got) == set(want['adapter'])
    for n, p in got.items():
        assert _rel_l2(p.numpy(), want['adapter'][n].numpy()) <= 1e-5, n


def test_circular_schedule_on_ranks_needs_m_equal_s(run):
    for r in run['ranks']:
        assert 'pipe_interleave 2' in r['refused'] \
            and 'M == S' in r['refused']


def test_fsdp_beside_pipe_is_refused_by_name(run):
    """JAX shards a stage's remaining dims over fsdp too; the port's
    placement runs without FSDP2 and refuses fsdp > 1 beside pipe."""
    for r in run['ranks']:
        assert "fsdp > 1 beside ['pipe']" in r['fsdp_refused'] \
            and 'item 5.10' in r['fsdp_refused']


def test_pipeline_config_checkpoint_is_the_one_device_layout(run):
    """``train_model`` with ``_pipeline_train.py`` over data=2 x pipe=2:
    the checkpoint rank 0 gathered is the live state bit for bit, and a
    process without a mesh resumes it."""
    r0 = run['ranks'][0]
    assert r0['ckb_mesh'] == {'data': 2, 'fsdp': 1, 'pipe': 2}
    raw = load_raw_checkpoint(run['ckb_dir'], CKB_ITERS)
    adapter, ema = r0['ckb']
    assert set(raw['trainable']['diffusion']) == set(adapter)
    for n, t in adapter.items():
        assert torch.equal(raw['trainable']['diffusion'][n], t), n
        assert torch.equal(raw['ema']['diffusion'][n], ema[n]), n
    (resumed, resumed_ema), step = run['resumed']
    assert step == CKB_ITERS
    for n, t in adapter.items():
        assert torch.equal(resumed[n], t) and torch.equal(resumed_ema[n],
                                                          ema[n]), n
