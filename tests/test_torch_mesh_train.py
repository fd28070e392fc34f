"""Port parity for mesh training: the ``data`` and ``fsdp`` axes
(``parallel.make_mesh``, FSDP2 through ``parallel.shard_model``) on gloo
ranks on the CPU, against the JAX package on one device and against the
port in one process.

* ``mesh_shape`` / ``mesh_ranks`` against JAX's ``make_mesh`` on the
  simulated devices: sizes with -1 and ``dcn_axes``, the device order, and
  the refusals with JAX's message (a product off the device count, and
  ``data=2, fsdp=-1`` on one device, where JAX's 1 // 2 = 0 gives a mesh
  of 0); ``tensor`` is refused by name, and ``pipe`` and ``expert`` meet
  the same size arithmetic.
* ``tests/test_parallel.py::test_sharded_matches_single_device``'s model
  and SGD step on 4 ranks at ``data=2, fsdp=2`` and on 2 ranks at
  ``fsdp=2``, against the JAX step on one device, at JAX's tolerance (loss
  rtol 1e-5; weights rtol 1e-5, atol 1e-6).
* The tiny ArcFlux distillation step of ``tests/test_torch_train.py`` on 4
  ranks at ``data=2, fsdp=2``, a global batch of 4 (one row a rank), the
  JAX draws replayed (each rank keeps its rows of them), against JAX's
  ``value_and_grad`` on the whole batch, then optax's AdamW and the JAX
  EMA: the loss within 1e-4 relative, the gradient norm and the adapter's
  update within 1e-3 (relative L2 per tensor), that file's tolerances, and
  the EMA (momentum 0.9) within the fp32 rounding of its lerp (rtol 1e-5,
  atol 1e-7). AdamW runs with eps 1e-2: its first step is g / (|g| +
  eps), which is sign(g) for eps << |g| and flips with any rounding of a
  gradient entry near 0; at 1e-2 the update follows the gradient
  smoothly. With LoRA dropout and checkpointing the 4 ranks equal the
  port's one-process step on the same batch and generator (loss rtol
  1e-5, updates 1e-4 relative L2, EMA as above: only the sums' order
  differs), and so do they with gradient accumulation over 2 micro-batches
  (a global batch of 8, each rank holding its row of each micro-batch,
  ``data.samplers.rank_rows``), where no rank reduces a gradient before
  the last micro-batch.
* ``train_model`` on ``configs/toy/checkerboard_flow.py`` with
  ``parallel.mesh=dict(data=2, fsdp=-1)`` and ``min_shard_size=1024`` on 4
  ranks (hidden 64, 16 rows a rank), 30 iterations, then a one-process
  resume to 40: the parameters are ``DTensor``s sharded over 2 ranks, the
  checkpoint of 4 ranks restores bitwise in one process and the 4 ranks
  restore a one-process checkpoint bitwise, every rank's gathered state
  equals rank 0's bit for bit, and
  one process fed the same global batch (the 4 ranks' loader rows
  concatenated) reaches the same parameters within rtol 1e-4, atol 1e-5
  after 30 AdamW steps (fp32 sums in another order). A mesh of one device
  trains bitwise as no mesh does.
* A SIGTERM to rank 1 alone: every rank stops at the same iteration, one
  checkpoint of it is written, nothing hangs.

JAX runs only in this process: inputs go to the ranks as files and their
results come back so. The rank functions live here at module level and the
module imports JAX only inside fixtures, so the ranks import no JAX. Each
rank runs ``torch.set_num_threads(1)``; the process group and each join are
bounded (60 s and 120 s).
"""

import copy
import importlib
import os
import signal
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from arcflow_tpu_torch import Config
from arcflow_tpu_torch.data.samplers import rank_rows
from arcflow_tpu_torch.apis import train as t_train
from arcflow_tpu_torch.models import LatentDiffusionTextImage
from arcflow_tpu_torch.models.base import BaseModel
from arcflow_tpu_torch.parallel import (make_mesh, setup_distributed,
                                        shard_model, spawn)
from arcflow_tpu_torch.parallel.fsdp import is_sharded
from arcflow_tpu_torch.parallel.mesh import batch_ranks, mesh_ranks, mesh_shape
from arcflow_tpu_torch.pipelines import load_jax_latent_diffusion
from arcflow_tpu_torch.runner import (EmaConfig, Hook, TrainState,
                                      build_optimizers, build_train_step,
                                      load_raw_checkpoint)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKERBOARD = os.path.join(REPO, 'configs/toy/checkerboard_flow.py')
RANKS = 4
SGD_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-4
REL_L2 = 1e-3
GLOBAL_BS = 4
ACCUM, ACCUM_BS = 2, 8  # micro-batches of a step, rows of its global batch
OPTIMIZER = dict(diffusion=dict(type='AdamW', lr=1e-3, betas=(0.9, 0.95),
                                eps=1e-2, weight_decay=0.0))
EMA_MOMENTUM = 0.9
# the EMA moves by a tenth of an update whose error the update's bound
# holds; what is left is the fp32 rounding of the lerp itself
EMA_TOL = dict(rtol=1e-5, atol=1e-7)
CKB_ROWS = 16           # checkerboard rows a rank
CKB_TOL = dict(rtol=1e-4, atol=1e-5)
SIGTERM_AT = 3
ONE_ITERS = 10          # the one-process checkpoint the ranks restore


# ---- the models ------------------------------------------------------------

class _Net(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(torch.as_tensor(w).clone())

    def forward(self, x):
        return x @ self.w


class LinearModel(BaseModel):
    """``test_sharded_matches_single_device``'s model: mean squared error of
    x w against y, w trainable."""

    def __init__(self, w):
        super().__init__()
        self.net = _Net(w)

    def fsdp_modules(self):
        return {'net': self.net}

    def init_params(self):
        return {'net': dict(self.net.named_parameters())}, {}

    def loss(self, batch, generator, running_status=None):
        return torch.square(self.net(batch['x']) - batch['y']).mean(), {}


# tests/test_torch_train.py's tiny tied teacher/student, in fp32
TINY_NET = dict(in_channels=16, num_layers=1, num_single_layers=2,
                attention_head_dim=16, num_attention_heads=4,
                joint_attention_dim=32, pooled_projection_dim=16,
                axes_dims_rope=(4, 6, 6), guidance_embeds=True)


def arcflux_cfg(lora_dropout=0.0, checkpointing=False):
    net = dict(TINY_NET, checkpointing=checkpointing)
    return dict(
        diffusion=dict(
            type='ArcFlowImitationDataFree', policy_type='ArcFlow',
            denoising=dict(type='ArcFluxTransformer2DModel', patch_size=2,
                           num_gaussians=4, lora_rank=4,
                           lora_dropout=lora_dropout, **net),
            flow_loss=dict(type='DiffusionMSELoss',
                           data_info=dict(pred='u_t_pred', target='u_t'),
                           rescale_cfg=dict(scale=30.0)),
            num_timesteps=1,
            timestep_sampler=dict(type='ContinuousTimeStepSampler',
                                  shift=3.2)),
        teacher=dict(type='GaussianFlow',
                     denoising=dict(type='FluxTransformer2DModel',
                                    patch_size=2, **net),
                     num_timesteps=1),
        tie_teacher=True, latent_shape=(8, 8, 4), text_embed_dim=32,
        pooled_dim=16,
        train_cfg=dict(nfe=2, timestep_ratio=1.0, total_substeps=128,
                       num_intermediate_states=2, window_substeps=3,
                       gm_dropout=0.1, num_decay_iters=100,
                       distilled_guidance_scale=3.5,
                       teacher_distilled_guidance_scale=3.5,
                       teacher_guidance_scale=2.0),
        test_cfg=dict(nfe=2, timestep_ratio=1.0, total_substeps=128,
                      distilled_guidance_scale=3.5))


def arcflux_batch(seed=0, rows=GLOBAL_BS):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        latents=rng.standard_normal((rows, 8, 8, 4)).astype(f),
        prompt_embed_kwargs=dict(
            encoder_hidden_states=rng.standard_normal(
                (rows, 6, 32)).astype(f),
            pooled_projections=rng.standard_normal(
                (rows, 16)).astype(f)),
        negative_prompt_embed_kwargs=dict(
            encoder_hidden_states=np.zeros((rows, 6, 32), f),
            pooled_projections=np.zeros((rows, 16), f)))


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _rows(tree, index, count, chunk=None):
    """Rank ``index`` of ``count``'s rows of a global batch (its block, or
    its row of each micro-batch of ``chunk`` rows a rank)."""
    def rows(x):
        pos = rank_rows(index, count, len(x) // count, chunk)
        return torch.from_numpy(np.ascontiguousarray(x[pos]))
    return _map(rows, tree)


def _full(t):
    return (t.full_tensor() if is_sharded(t) else t).detach().clone()


def _replaying(draws):
    """torch.rand / torch.randn stand-ins returning the recorded global
    draws in order, checking kind and shape."""
    it = iter(draws)

    def make(kind):
        def fn(*size, generator=None, device=None, dtype=None, **kwargs):
            if len(size) == 1 and not isinstance(size[0], int):
                size = tuple(size[0])
            got, x = next(it)
            assert (got, x.shape) == (kind, tuple(size))
            return torch.from_numpy(np.array(x, np.float32)).to(device)
        return fn
    return make('uniform'), make('normal'), it


# ---- what runs on a rank and in one process -------------------------------

def sgd_step(inputs, mesh):
    model = LinearModel(inputs['w0'])
    if mesh is not None:
        shard_model(model, mesh)
    index, count = batch_ranks(mesh) if mesh is not None else (0, 1)
    trainable, _ = model.init_params()
    opt = {'net': torch.optim.SGD(list(trainable['net'].values()), lr=0.1)}
    state = TrainState.create(torch.Generator(), trainable, {}, opt)
    step = build_train_step(model, opt, mesh=mesh)
    state, logs = step(state, _rows(dict(x=inputs['x'], y=inputs['y']),
                                    index, count))
    return dict(loss=float(logs['loss']),
                w=_full(state.trainable['net']['w']))


def arcflux_step(inputs, mesh, variant):
    """One ``build_train_step`` step of the tiny distillation: 'replay'
    with the JAX draws, 'dropout' with LoRA dropout and checkpointing from
    the port's own generator, 'accum' so over ACCUM micro-batches of the
    batch of ACCUM_BS rows (recording, as each micro-batch starts, whether
    any adapter parameter holds a gradient)."""
    cfg = arcflux_cfg() if variant == 'replay' else \
        arcflux_cfg(lora_dropout=0.1, checkpointing=True)
    model = LatentDiffusionTextImage(device='cpu', dtype=torch.float32,
                                     **copy.deepcopy(cfg))
    load_jax_latent_diffusion(model, inputs['trainable'], inputs['frozen'])
    accum = ACCUM if variant == 'accum' else 1
    reduced = []
    if accum > 1:
        loss = model.loss

        def recording(*args, **kwargs):
            reduced.append(any(p.grad is not None for p in
                               model.init_params()[0]['diffusion'].values()))
            return loss(*args, **kwargs)
        model.loss = recording
    if mesh is not None:
        shard_model(model, mesh)
    index, count = batch_ranks(mesh) if mesh is not None else (0, 1)
    trainable, frozen = model.init_params()
    before = {n: _full(p) for n, p in trainable['diffusion'].items()}
    optimizers = build_optimizers(copy.deepcopy(OPTIMIZER), trainable)
    state = TrainState.create(torch.Generator().manual_seed(11), trainable,
                              frozen, optimizers, ema_keys=model.ema_keys)
    step = build_train_step(
        model, optimizers,
        ema_cfg=EmaConfig(momentum_policy='fixed', momentum=EMA_MOMENTUM),
        grad_accum_steps=accum, mesh=mesh)
    batch = _rows(inputs['batch'], index, count) if accum == 1 else \
        _rows(inputs['batch_accum'], index, count,
              ACCUM_BS // count // accum)
    if variant == 'replay':
        rand, randn, rest = _replaying(inputs['draws'])
        with mock.patch.object(torch, 'rand', rand), \
                mock.patch.object(torch, 'randn', randn):
            state, logs = step(state, batch)
        assert next(rest, None) is None
    else:
        state, logs = step(state, batch)
    return dict(loss=float(logs['loss']),
                gnorm=float(logs['diffusion_grad_norm']), before=before,
                adapter={n: _full(p) for n, p in
                         state.trainable['diffusion'].items()},
                ema={n: _full(p) for n, p in state.ema['diffusion'].items()},
                reduced=reduced,
                sharded=sum(is_sharded(p) for p in
                            state.trainable['diffusion'].values()))


def checkerboard_cfg(mesh=True, samples=CKB_ROWS):
    cfg = Config.fromfile(CHECKERBOARD)
    cfg.merge_from_dict({'model.diffusion.denoising.hidden': (64, 64),
                         'data.train_dataloader.samples_per_gpu': samples,
                         'checkpoint_config.interval': 10,
                         'log_config.interval': 10})
    if mesh:
        cfg.merge_from_dict({'parallel': dict(mesh=dict(data=2, fsdp=-1),
                                              fsdp_axis='fsdp',
                                              tensor_axis=None,
                                              min_shard_size=1024)})
    return cfg


def live_state(state):
    """Every tensor of a state gathered whole: trainable, EMA and the
    optimizer slots."""
    opt = state.optimizers['diffusion'].state_dict()['state']
    return dict(trainable=_map(_full, state.trainable),
                ema=_map(_full, state.ema),
                opt={f'{i}.{k}': _full(v) for i, s in opt.items()
                     for k, v in s.items()})


def saved_state(directory, step):
    raw = load_raw_checkpoint(directory, step)
    return dict(trainable=raw['trainable'], ema=raw['ema'],
                opt={f'{i}.{k}': v for i, s in
                     raw['optimizers']['diffusion']['state'].items()
                     for k, v in s.items()})


def same_state(a, b):
    """Whether two trees hold the same values, tensors bit for bit."""
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k], fb[k]) if isinstance(fa[k], torch.Tensor)
        else fa[k] == fb[k] for k in fa)


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = v
    return out


class _SigtermOnRank1(Hook):
    def after_train_iter(self, runner):
        if runner.iter == SIGTERM_AT and dist.get_rank() == 1:
            os.kill(os.getpid(), signal.SIGTERM)


def _with_hook(hook):
    real = t_train.build_hooks

    def build(*args, extra_hooks=(), **kwargs):
        return real(*args, extra_hooks=[*extra_hooks, hook], **kwargs)
    return mock.patch.object(t_train, 'build_hooks', build)


def _rank_main(tmp, phase):
    torch.set_num_threads(1)
    setup_distributed('cpu', timeout=60.0)
    rank = dist.get_rank()
    out = {}
    if phase == 'fsdp2':
        inputs = torch.load(os.path.join(tmp, 'sgd.pt'), weights_only=False)
        out['sgd'] = sgd_step(inputs, make_mesh({'fsdp': 2}))
    elif phase == 'first':
        inputs = torch.load(os.path.join(tmp, 'sgd.pt'), weights_only=False)
        mesh = make_mesh({'data': 2, 'fsdp': 2})
        out['sgd'] = sgd_step(inputs, mesh)
        inputs = torch.load(os.path.join(tmp, 'arcflux.pt'),
                            weights_only=False)
        for variant in ('replay', 'dropout', 'accum'):
            out[variant] = arcflux_step(inputs, mesh, variant)
        state, _ = t_train.train_model(
            checkerboard_cfg(), work_dir=os.path.join(tmp, 'ckb'),
            device='cpu', max_iters=30)
        out['ckb30'] = live_state(state)
        w = state.trainable['diffusion']['LoRADense_1.weight']
        out['ckb_shards'] = (tuple(w.shape), tuple(w.to_local().shape),
                             w.device_mesh.size(1))
        # the one-process checkpoint at ONE_ITERS, restored on these ranks
        state, _ = t_train.train_model(
            checkerboard_cfg(), work_dir=os.path.join(tmp, 'one'),
            device='cpu', max_iters=ONE_ITERS)
        out['one_restored'] = live_state(state)
        with _with_hook(_SigtermOnRank1()):
            state, _ = t_train.train_model(
                checkerboard_cfg(), work_dir=os.path.join(tmp, 'sigterm'),
                device='cpu', max_iters=30)
        out['sigterm_step'] = state.step
    torch.save(out, os.path.join(tmp, f'{phase}{rank}.pt'))
    dist.destroy_process_group()


def _results(tmp, phase, n):
    return [torch.load(os.path.join(tmp, f'{phase}{r}.pt'),
                       weights_only=False) for r in range(n)]


# ---- the runs ----------------------------------------------------------------

@pytest.fixture(scope='module')
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from arcflow_tpu.runner import TrainState as JTrainState
    from arcflow_tpu.runner import build_optimizers as j_build_optimizers
    from arcflow_tpu.runner import build_train_step as j_build_train_step
    from arcflow_tpu.runner.ema import EmaConfig as JEmaConfig
    from arcflow_tpu.runner.ema import ema_update as j_ema_update
    from arcflow_tpu_torch.pipelines import jax_params_to_torch
    tt = importlib.import_module('test_torch_train')
    tq = importlib.import_module('test_torch_qwen_train')

    tmp = str(tmp_path_factory.mktemp('mesh'))
    res = {}

    # test_parallel.py's model and SGD step, on one device
    w0 = jax.random.normal(jax.random.PRNGKey(0), (64, 64))
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 64))
    y = jax.random.normal(jax.random.PRNGKey(2), (16, 64))

    class M:
        def loss(self, tr, fr, rng, batch, running_status=None):
            pred = batch['x'] @ tr['net']['w']
            return jnp.square(pred - batch['y']).mean(), {}

    opt = {'net': optax.sgd(0.1)}
    state = JTrainState.create(jax.random.PRNGKey(3), {'net': {'w': w0}},
                               {}, opt)
    state, logs = j_build_train_step(M(), opt, donate=False)(
        state, {'x': x, 'y': y})
    res['jax_sgd'] = dict(loss=float(logs['loss']),
                          w=np.asarray(state.trainable['net']['w']))
    torch.save(dict(w0=np.asarray(w0), x=np.asarray(x), y=np.asarray(y)),
               os.path.join(tmp, 'sgd.pt'))

    # the tiny distillation step, on one device, draws recorded
    cfg = arcflux_cfg()
    jm = tt.jax_model(cfg)
    trainable, frozen = jax.jit(jm.init_params)(jax.random.PRNGKey(1))
    trainable, frozen = tt._jitter(trainable, 7), tt._jitter(frozen, 8)
    batch = arcflux_batch()
    with mock.patch.object(tt, 'jax_model', lambda c: jm), \
            mock.patch.object(jm.diffusion, 'pred', tq._jitted_pred(
                jm.diffusion)), \
            mock.patch.object(jm.teacher, 'pred', tq._jitted_pred(
                jm.teacher)):
        j_loss, _, j_grads, draws = tt._jax_loss_and_grads(
            cfg, trainable, frozen, batch, iteration=0)
    params = _map(jnp.asarray, trainable['diffusion'])
    tx = j_build_optimizers(copy.deepcopy(OPTIMIZER),
                            {'diffusion': params})['diffusion']
    updates, _ = tx.update(j_grads['diffusion'], tx.init(params), params)
    new = optax.apply_updates(params, updates)
    ema = j_ema_update(JEmaConfig(enabled=True, momentum_policy='fixed',
                                  momentum=EMA_MOMENTUM), params, new, 0)
    res['jax_arcflux'] = dict(
        loss=j_loss, gnorm=float(optax.global_norm(j_grads['diffusion'])),
        adapter=jax_params_to_torch(jax.device_get(new)),
        ema=jax_params_to_torch(jax.device_get(ema)))
    arcflux = dict(trainable=trainable, frozen=frozen, batch=batch,
                   draws=draws, batch_accum=arcflux_batch(1, ACCUM_BS))
    torch.save(arcflux, os.path.join(tmp, 'arcflux.pt'))
    res['one_dropout'] = arcflux_step(arcflux, None, 'dropout')
    res['one_accum'] = arcflux_step(arcflux, None, 'accum')

    # one process writes the checkpoint the ranks restore
    one = os.path.join(tmp, 'one')
    t_train.train_model(checkerboard_cfg(mesh=False), one, device='cpu',
                        max_iters=ONE_ITERS)
    res['saved_one'] = saved_state(
        os.path.join(one, 'checkpoints', 'checkerboard_flow'), ONE_ITERS)

    spawn(_rank_main, RANKS, (tmp, 'first'), timeout=120.0)
    res['first'] = _results(tmp, 'first', RANKS)
    res['sigterm_steps'] = sorted(os.listdir(os.path.join(
        tmp, 'sigterm', 'checkpoints', 'checkerboard_flow')))
    spawn(_rank_main, 2, (tmp, 'fsdp2'), timeout=120.0)
    res['fsdp2'] = _results(tmp, 'fsdp2', 2)

    # one process: restore the 4 ranks' checkpoint at 30, train on to 40
    ckb = os.path.join(tmp, 'ckb')
    directory = os.path.join(ckb, 'checkpoints', 'checkerboard_flow')
    res['saved30'] = saved_state(directory, 30)
    state, _ = t_train.train_model(checkerboard_cfg(mesh=False), ckb,
                                   device='cpu', max_iters=30)
    res['one_restored30'] = live_state(state)
    state, _ = t_train.train_model(checkerboard_cfg(mesh=False), ckb,
                                   device='cpu', max_iters=40)
    res['resumed40'] = state.step

    # one process on the 4 ranks' global batch: their loader rows, joined
    real_loader = t_train.build_dataloader

    def joined(dataset, samples, num_replicas, rank, **kw):
        per_rank = [real_loader(dataset, samples // RANKS, **kw,
                                num_replicas=RANKS, rank=r)
                    for r in range(RANKS)]
        while True:
            parts = [next(it) for it in per_rank]
            yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    with mock.patch.object(t_train, 'build_dataloader', joined):
        state, _ = t_train.train_model(
            checkerboard_cfg(mesh=False, samples=RANKS * CKB_ROWS),
            os.path.join(tmp, 'joined'), device='cpu', max_iters=30)
    res['joined30'] = live_state(state)
    return res


# ---- the mesh ---------------------------------------------------------------

MESHES = [({'data': 2, 'fsdp': 4}, None), ({'data': 2, 'fsdp': -1}, None),
          ({'fsdp': 2, 'data': -1}, None), ({'data': 1, 'fsdp': -1},
                                           {'data': 2}),
          ({'data': -1, 'fsdp': 2}, {'data': 2})]


@pytest.mark.parametrize('axes, dcn', MESHES)
def test_mesh_shape_and_order_match_jax(axes, dcn):
    import jax
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    mesh = j_make_mesh(dict(axes), dcn_axes=dcn)
    sizes = mesh_shape(axes, len(jax.devices()), dcn)
    assert sizes == dict(mesh.shape)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    order = [list(mesh.shape).index(a) for a in ('data', 'fsdp')]
    np.testing.assert_array_equal(mesh_ranks(sizes).numpy(),
                                  ids.transpose(order))


@pytest.mark.parametrize('axes, n, dcn', [
    ({'data': 3, 'fsdp': 2}, 8, None), ({'data': 2, 'fsdp': -1}, 1, None),
    ({'data': 2, 'fsdp': 2}, 4, {'data': 2})])
def test_mesh_refusals_match_jax(axes, n, dcn):
    import jax
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    with pytest.raises(AssertionError) as want:
        j_make_mesh(dict(axes), devices=jax.devices()[:n], dcn_axes=dcn)
    with pytest.raises(ValueError) as got:
        mesh_shape(axes, n, dcn)
    assert str(got.value) == str(want.value)


def test_one_process_refuses_the_shipped_mesh():
    """``data=2, fsdp=-1`` in one process (no group: a world of 1) is
    refused with JAX's one-device message."""
    with pytest.raises(ValueError,
                       match=r"mesh \{'data': 2, 'fsdp': 0\} != 1 devices"):
        make_mesh({'data': 2, 'fsdp': -1})


@pytest.mark.parametrize('axis', ['tensor', 'pipe', 'expert'])
def test_waiting_axes_are_refused_by_name(axis):
    """No axis waits now: ``tensor`` (``tests/test_torch_tensor_parallel.
    py``), ``pipe`` and ``expert`` (``tests/test_torch_pipeline_parallel.
    py``) are axes of the mesh; in one process each meets JAX's device
    count (fsdp = 1 // 2 = 0), as a ``data`` / ``fsdp`` mesh does. What
    still waits is a composition: ``tensor`` beside ``pipe`` (item 5.12)
    is refused by name."""
    if axis == 'tensor':
        with pytest.raises(NotImplementedError,
                           match=r"\['pipe'\] beside 'tensor'.*queue A "
                                 r"item 5\.12"):
            make_mesh({'data': 1, 'fsdp': -1, 'pipe': 2, axis: 2})
    with pytest.raises(ValueError, match=rf"mesh \{{'data': 1, 'fsdp': 0, "
                       rf"'{axis}': 2\}} != 1 devices"):
        make_mesh({'data': 1, 'fsdp': -1, axis: 2})
    assert mesh_shape({'data': -1, axis: 2}, 4) == {'data': 2, axis: 2}


def test_train_model_refuses_a_tensor_axis():
    """``parallel.tensor_axis`` is 'tensor' or None, as in JAX's configs;
    another name is refused. 'tensor' with a mesh whose tensor axis is 1
    trains as the ``data`` / ``fsdp`` mesh does (the tensor split itself:
    ``tests/test_torch_tensor_parallel.py``)."""
    cfg = checkerboard_cfg()
    cfg.merge_from_dict({'parallel.tensor_axis': 'model'})
    with pytest.raises(ValueError, match='tensor_axis must be "tensor"'):
        t_train.train_model(cfg, device='cpu', max_iters=1)
    cfg.merge_from_dict({'parallel.tensor_axis': 'tensor',
                         'parallel.mesh': dict(data=1, fsdp=1, tensor=1)})
    assert t_train.parallel_from_cfg(cfg)['axes'] == dict(data=1, fsdp=1,
                                                          tensor=1)


def test_one_device_mesh_trains_as_no_mesh(tmp_path):
    """The same code at world size 1 (FSDP2 over a mesh of one device in
    a one-process group): bitwise the unsharded run."""
    states = []
    for mesh in (False, True):
        cfg = checkerboard_cfg(mesh=False)
        if mesh:
            cfg.merge_from_dict({'parallel': dict(mesh=dict(data=1,
                                                            fsdp=-1))})
        state, _ = t_train.train_model(cfg, str(tmp_path / str(mesh)),
                                       device='cpu', max_iters=5)
        states.append(live_state(state))
    assert same_state(*states)
    assert not dist.is_initialized()


def test_ema_swap_reaches_sharded_parameters():
    """``swapped_params`` (evaluation with the EMA) copies into a sharded
    parameter's shard, which FSDP2 gathers, and puts it back."""
    from arcflow_tpu_torch.models.base import swapped_params
    from arcflow_tpu_torch.parallel.fsdp import local
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    setup_distributed('cpu')
    try:
        model = LinearModel(w)
        shard_model(model, make_mesh({'data': 1, 'fsdp': -1}))
        ema = {'w': model.net.w.detach().clone()}
        local(ema['w']).mul_(2.0)
        with torch.no_grad():
            with swapped_params(model.net, ema):
                swapped = model.net(x)
            own = model.net(x)
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(swapped, x @ (2.0 * w), rtol=0, atol=0)
    torch.testing.assert_close(own, x @ w, rtol=0, atol=0)


# ---- the sharded steps against JAX --------------------------------------------

@pytest.mark.parametrize('layout', ['first', 'fsdp2'])
def test_sgd_step_matches_jax_single_device(run, layout):
    want = run['jax_sgd']
    for r in run[layout]:
        np.testing.assert_allclose(r['sgd']['loss'], want['loss'], rtol=1e-5)
        np.testing.assert_allclose(r['sgd']['w'].numpy(), want['w'],
                                   **SGD_TOL)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_distillation_step_matches_jax(run):
    want = run['jax_arcflux']
    got = run['first'][0]['replay']
    assert got['sharded'] == len(got['adapter'])
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got['gnorm'], want['gnorm'], rtol=REL_L2)
    assert set(got['adapter']) == set(want['adapter'])
    for n, p in got['adapter'].items():
        before = got['before'][n].numpy()
        err = _rel_l2(p.numpy() - before, want['adapter'][n].numpy() - before)
        assert err <= REL_L2, (n, err)
        np.testing.assert_allclose(got['ema'][n].numpy(),
                                   want['ema'][n].numpy(), **EMA_TOL)


def test_distillation_with_dropout_is_the_one_process_step(run):
    """LoRA dropout masks and every per-sample draw are each rank's rows of
    the global batch's draws, the checkpointed recompute included."""
    want = run['one_dropout']
    got = run['first'][0]['dropout']
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    np.testing.assert_allclose(got['gnorm'], want['gnorm'], rtol=1e-4)
    for n, p in got['adapter'].items():
        before = want['before'][n].numpy()
        assert _rel_l2(p.numpy() - before,
                       want['adapter'][n].numpy() - before) <= 1e-4, n
        np.testing.assert_allclose(got['ema'][n].numpy(),
                                   want['ema'][n].numpy(), **EMA_TOL)


def test_accumulation_is_the_one_process_step(run):
    """Under gradient accumulation micro-batch i of the 4 ranks is micro-
    batch i of the global batch (the same rows, draws and dropout masks as
    in one process), and the ranks reduce the gradients once, after the
    last micro-batch: none holds a gradient as a micro-batch starts."""
    want = run['one_accum']
    assert want['reduced'] == [False, True]
    for got in (r['accum'] for r in run['first']):
        assert got['reduced'] == [False] * ACCUM
        np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
        np.testing.assert_allclose(got['gnorm'], want['gnorm'], rtol=1e-4)
        for n, p in got['adapter'].items():
            before = want['before'][n].numpy()
            assert _rel_l2(p.numpy() - before,
                           want['adapter'][n].numpy() - before) <= 1e-4, n
            np.testing.assert_allclose(got['ema'][n].numpy(),
                                       want['ema'][n].numpy(), **EMA_TOL)


@pytest.mark.parametrize('rank, n, rows, chunk, want', [
    (1, 4, 2, None, [2, 3]), (1, 4, 2, 2, [2, 3]), (1, 4, 2, 1, [1, 5]),
    (2, 4, 4, 2, [4, 5, 12, 13]), (0, 1, 4, 1, [0, 1, 2, 3])])
def test_rank_rows_deal_each_micro_batch_over_the_ranks(rank, n, rows, chunk,
                                                        want):
    """A rank's rows of the global batch: its block without accumulation;
    with it, its part of each of JAX's micro-batches (``_chunk_batch``
    reshapes the global batch to (steps, B // steps, ...))."""
    assert rank_rows(rank, n, rows, chunk).tolist() == want
    if chunk:
        steps = rows // chunk
        jax_chunks = np.arange(n * rows).reshape(steps, -1)
        mine = np.asarray(want).reshape(steps, chunk)
        for i in range(steps):
            assert set(mine[i]) <= set(jax_chunks[i])


@pytest.mark.parametrize('phase', ['first', 'fsdp2'])
def test_every_rank_holds_rank0_state(run, phase):
    """Losses, norms, gathered parameters, EMA and optimizer slots."""
    ranks = run[phase]
    for r in ranks[1:]:
        assert same_state(r, ranks[0])


# ---- checkpoints, resume and preemption ---------------------------------------

def test_checkerboard_parameters_are_sharded(run):
    full, local, fsdp = run['first'][0]['ckb_shards']
    assert fsdp == 2 and local[0] * 2 == full[0] and local[1:] == full[1:]


def test_four_rank_checkpoint_restores_bitwise_in_one_process(run):
    assert same_state(run['first'][0]['ckb30'], run['saved30'])
    assert same_state(run['one_restored30'], run['saved30'])


def test_one_process_checkpoint_restores_bitwise_on_four_ranks(run):
    assert same_state(run['first'][0]['one_restored'], run['saved_one'])
    assert run['resumed40'] == 40


def test_four_ranks_train_as_one_process_on_their_global_batch(run):
    got = _flat(run['first'][0]['ckb30']['trainable'])
    want = _flat(run['joined30']['trainable'])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **CKB_TOL, err_msg=k)


def test_sigterm_to_one_rank_stops_every_rank_with_one_checkpoint(run):
    assert [r['sigterm_step'] for r in run['first']] == [SIGTERM_AT] * RANKS
    assert run['sigterm_steps'] == [str(SIGTERM_AT)]
