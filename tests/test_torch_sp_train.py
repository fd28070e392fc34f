"""Port parity for training under the ``sp`` axis: the ring's backward, the
differentiable Ulysses layout and ``sp`` beside ``data`` / ``fsdp`` in the
training mesh, on the CPU.

* The ring backward (``parallel/ring_attention.py``, one
  ``attention_bwd_ref`` per hop on the CPU) on ``LocalRing(2/3/4)``
  against ``jax.grad`` of the JAX ring (its plain tier, which JAX's flash
  tier also rematerializes through) on the simulated CPU mesh, S = 48 in
  fp32: unmasked, key-padded (row 0's last shards all padding) and with a
  row that has no valid key (its output the mean of v, so every key's dv
  gets sum dO / S). Tolerance rtol 1e-5, atol 2e-6 on dq, dk, dv: the
  same sums in another order, as ``test_torch_ring_attention.py``'s
  output tolerance.
* The tiny ArcFlux distillation step of ``tests/test_torch_mesh_train.py``
  (at 1 joint + 1 single block) and the tiny ArcQwen one of ``tests/test_torch_qwen_train.py`` (4 heads
  of 16 so that Ulysses splits them over 4 ranks; 8 text tokens, 5 valid
  in row 0, so the ring folds fully masked blocks) on 4 gloo ranks in one
  spawn, at ``sp=4`` ring, ``sp=4`` Ulysses and ``fsdp=2 x sp=2`` ring,
  a global batch of 2: with the JAX draws replayed and dropout off,
  against JAX's single-device ``value_and_grad``, optax's AdamW and the
  JAX EMA on the same weights (loss within 1e-4 relative, the gradient
  norm and each adapter tensor's update within 1e-3 relative L2, the EMA
  within rtol 1e-5, atol 1e-7: ``test_torch_mesh_train.py``'s bounds,
  AdamW with eps 1e-2 for the reason given there). The ArcFlux text
  stream (6 tokens) is padded to 8 at ``sp=4``.
* With LoRA dropout (0.1) and checkpointing each case equals the port's
  own one-process step on the same batch and generator (loss rtol 1e-5,
  gradient norm 1e-4, updates 1e-4 relative L2): every rank of an sp group
  draws the masks of its tokens out of the single-device draw.
* Every rank's state equals rank 0's bit for bit, the ranks of an sp group
  hold the same batch rows, and the 3-D mesh places the ranks as JAX
  places its devices.

JAX runs only in this process: the configs, weights, inputs and JAX's
results go to the ranks as one file. The rank function lives here at module
level and the module imports JAX only inside functions, so the ranks import
no JAX. Each rank runs ``torch.set_num_threads(1)``; the process group is
bounded at 60 s and the spawn at 120 s.
"""

import copy
import importlib
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from arcflow_tpu_torch.models import LatentDiffusionTextImage
from arcflow_tpu_torch.models import layers as t_layers
from arcflow_tpu_torch.parallel import (LocalRing, SequenceParallel,
                                        make_mesh, ring_attention,
                                        set_sequence_parallel,
                                        setup_distributed, shard_model, spawn)
from arcflow_tpu_torch.parallel.fsdp import is_sharded
from arcflow_tpu_torch.parallel.mesh import batch_ranks, mesh_ranks
from arcflow_tpu_torch.pipelines import load_jax_latent_diffusion
from arcflow_tpu_torch.runner import (EmaConfig, TrainState,
                                      build_optimizers, build_train_step)

torch.set_num_threads(1)

RANKS = 4
GRAD_TOL = dict(rtol=1e-5, atol=2e-6)
LOSS_RTOL = 1e-4
REL_L2 = 1e-3
EMA_TOL = dict(rtol=1e-5, atol=1e-7)
EMA_MOMENTUM = 0.9
OPTIMIZER = dict(diffusion=dict(type='AdamW', lr=1e-3, betas=(0.9, 0.95),
                                eps=1e-2, weight_decay=0.0))
GLOBAL_BS = 2
FAMILIES = ('flux', 'qwen')
LAYOUTS = {'sp4_ring': (dict(data=1, fsdp=1, sp=4), 'ring'),
           'sp4_ulysses': (dict(data=1, fsdp=1, sp=4), 'ulysses'),
           'fsdp2_sp2_ring': (dict(data=1, fsdp=2, sp=2), 'ring')}
# the JAX ring's simulated meshes (8 CPU devices; 6 of them for sp = 3)
JAX_MESHES = {2: {'data': 4, 'sp': 2}, 3: {'data': 2, 'sp': 3},
              4: {'data': 2, 'sp': 4}}
CKB_ITERS = 3           # train_model's run under sp, its checkpoint at the end
S = 48
RING_CASES = {'unmasked': None, 'padded': (30, 48), 'keyless': (0, 40)}


# ---- the ring backward against jax.grad ---------------------------------------

def _ring_inputs(seed, lengths, b=2, h=3, d=16):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, S, h, d)).astype(np.float32)
                   for _ in range(4))
    valid = None if lengths is None else \
        np.arange(S)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, do, valid


def _jax_ring_grads(q, k, v, do, valid, size):
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    from arcflow_tpu.parallel import ring_attention as j_ring_attention
    n_dev = 2 * size if size == 3 else None
    mesh = j_make_mesh(JAX_MESHES[size],
                       devices=None if n_dev is None else jax.devices()[:n_dev])
    kv = None if valid is None else jnp.asarray(valid)

    def f(q, k, v):
        out = j_ring_attention(q, k, v, mesh, 'sp', kv_valid=kv,
                               use_flash=False)
        return jnp.sum(out * jnp.asarray(do))
    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize('case', list(RING_CASES))
@pytest.mark.parametrize('size', [2, 3, 4])
def test_ring_backward_matches_jax_grad(size, case):
    q, k, v, do, valid = _ring_inputs(size, RING_CASES[case])
    want = _jax_ring_grads(q, k, v, do, valid, size)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ring_attention(*leaves, None if valid is None
                         else torch.from_numpy(valid), LocalRing(size))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)
    if case == 'keyless':
        # row 0 attends to nothing: its dq is 0 and every key's dv is
        # sum_q dO / S (the JAX plain tier's uniform -1e30 scores)
        assert not got[0][0].any() and not got[1][0].any()
        np.testing.assert_allclose(
            got[2][0].numpy(),
            np.broadcast_to(do[0].sum(axis=0) / S, got[2][0].shape),
            **GRAD_TOL)


def test_keyless_rows_get_the_mean_of_do():
    """Both rows keyless: every key's dv is sum_q dO / S of its row and
    dq = dk = 0."""
    q, k, v, do, valid = _ring_inputs(7, (0, 0))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ring_attention(*leaves, torch.from_numpy(valid), LocalRing(4))
    dq, dk, dv = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert not dq.any() and not dk.any()
    want = np.broadcast_to(do.sum(axis=1, keepdims=True) / S, dv.shape)
    np.testing.assert_allclose(dv.numpy(), want, **GRAD_TOL)


# ---- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize('axes', [{'data': 2, 'fsdp': 2, 'sp': 2},
                                  {'sp': 2, 'fsdp': 2, 'data': -1},
                                  {'fsdp': 4, 'sp': 2}])
def test_mesh_with_sp_places_ranks_as_jax(axes):
    """The ('data', 'fsdp', 'sp') grid against JAX's ``make_mesh`` on the 8
    simulated devices: rank r where JAX puts device r."""
    import jax
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    from arcflow_tpu_torch.parallel.mesh import mesh_shape
    mesh = j_make_mesh(dict(axes))
    sizes = mesh_shape(axes, len(jax.devices()))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    names = list(mesh.shape)
    for a in ('data', 'fsdp', 'sp'):
        if a not in names:
            ids, names = ids[..., None], names + [a]
    order = [names.index(a) for a in ('data', 'fsdp', 'sp')]
    np.testing.assert_array_equal(mesh_ranks(sizes).numpy(),
                                  ids.transpose(order))


# ---- the steps on 4 ranks and in one process -------------------------------------

def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _full(t):
    return (t.full_tensor() if is_sharded(t) else t).detach().clone()


def _rows(tree, index, count):
    def rows(x):
        b = len(x) // count
        return torch.from_numpy(np.ascontiguousarray(
            x[index * b:(index + 1) * b]))
    return _map(rows, tree)


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


def sp_step(fam, mesh, mode, variant):
    """One ``build_train_step`` step of a family's tiny distillation on
    ``mesh`` (None: one process) in ``mode``: 'replay' with JAX's draws and
    no dropout, 'dropout' with LoRA dropout and checkpointing from the
    port's own generator."""
    cfg = fam['cfg' if variant == 'replay' else 'cfg_dropout']
    model = LatentDiffusionTextImage(device='cpu', dtype=torch.float32,
                                     **copy.deepcopy(cfg))
    load_jax_latent_diffusion(model, fam['trainable'], fam['frozen'])
    if mesh is not None:
        set_sequence_parallel(model, SequenceParallel(mesh.get_group('sp'),
                                                      mode))
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
        mesh=mesh)
    batch = _rows(fam['batch'], index, count)
    if variant == 'replay':
        rand, randn, rest = _replaying(fam['draws'])
        with mock.patch.object(torch, 'rand', rand), \
                mock.patch.object(torch, 'randn', randn):
            state, logs = step(state, batch)
        assert next(rest, None) is None
    else:
        state, logs = step(state, batch)
    return dict(loss=float(logs['loss']), rows=(index, count),
                gnorm=float(logs['diffusion_grad_norm']), before=before,
                adapter={n: _full(p) for n, p in
                         state.trainable['diffusion'].items()},
                ema={n: _full(p) for n, p in state.ema['diffusion'].items()})


def _rank_main(tmp):
    torch.set_num_threads(1)
    setup_distributed('cpu', timeout=60.0)
    inputs = torch.load(os.path.join(tmp, 'inputs.pt'), weights_only=False)
    out = {}
    for layout, (axes, mode) in LAYOUTS.items():
        mesh = make_mesh(dict(axes))
        for family in FAMILIES:
            for variant in ('replay', 'dropout'):
                out[family, layout, variant] = sp_step(
                    inputs[family], mesh, mode, variant)
    # train_model over data=1 x fsdp=2 x sp=2, with its checkpoint
    tmt = importlib.import_module('test_torch_mesh_train')
    from arcflow_tpu_torch.apis import train as t_train
    cfg = tmt.checkerboard_cfg()
    cfg.merge_from_dict({'parallel.mesh': dict(data=1, fsdp=2, sp=2)})
    state, _ = t_train.train_model(cfg, work_dir=os.path.join(tmp, 'ckb'),
                                   device='cpu', max_iters=CKB_ITERS)
    out['ckb'] = tmt.live_state(state)
    torch.save(out, os.path.join(tmp, f'rank{dist.get_rank()}.pt'))
    dist.destroy_process_group()


def _jax_reference(jax_loss_and_grads, cfg, trainable, frozen, batch):
    """JAX's loss, gradient norm, AdamW update and EMA on one device, and
    the draws of its loss."""
    import jax
    import jax.numpy as jnp
    import optax
    from arcflow_tpu.runner import build_optimizers as j_build_optimizers
    from arcflow_tpu.runner.ema import EmaConfig as JEmaConfig
    from arcflow_tpu.runner.ema import ema_update as j_ema_update
    from arcflow_tpu_torch.pipelines import jax_params_to_torch
    loss, _, grads, draws = jax_loss_and_grads(cfg, trainable, frozen,
                                               batch, iteration=0)
    params = _map(jnp.asarray, trainable['diffusion'])
    tx = j_build_optimizers(copy.deepcopy(OPTIMIZER),
                            {'diffusion': params})['diffusion']
    updates, _ = tx.update(grads['diffusion'], tx.init(params), params)
    new = optax.apply_updates(params, updates)
    ema = j_ema_update(JEmaConfig(enabled=True, momentum_policy='fixed',
                                  momentum=EMA_MOMENTUM), params, new, 0)
    return dict(loss=loss, gnorm=float(optax.global_norm(grads['diffusion'])),
                adapter=jax_params_to_torch(jax.device_get(new)),
                ema=jax_params_to_torch(jax.device_get(ema))), draws


def _with_dropout(cfg):
    cfg = copy.deepcopy(cfg)
    for part in ('diffusion', 'teacher'):
        cfg[part]['denoising']['checkpointing'] = True
    cfg['diffusion']['denoising']['lora_dropout'] = 0.1
    return cfg


@pytest.fixture(scope='module')
def sp_run(tmp_path_factory):
    import jax
    tt = importlib.import_module('test_torch_train')
    tq = importlib.import_module('test_torch_qwen_train')
    tmt = importlib.import_module('test_torch_mesh_train')
    tmp = str(tmp_path_factory.mktemp('sp_train'))
    inputs, res = {}, {}

    # ArcFlux: test_torch_mesh_train.py's tiny pair at 1 + 1 blocks (each
    # JAX block costs seconds of compile), its denoisers jitted
    cfg = tmt.arcflux_cfg()
    for part in ('diffusion', 'teacher'):
        cfg[part]['denoising']['num_single_layers'] = 1
    jm = tt.jax_model(cfg)
    trainable, frozen = jax.jit(jm.init_params)(jax.random.PRNGKey(1))
    trainable, frozen = tt._jitter(trainable, 7), tt._jitter(frozen, 8)
    batch = tmt.arcflux_batch(rows=GLOBAL_BS)
    with mock.patch.object(tt, 'jax_model', lambda c: jm), \
            mock.patch.object(jm.diffusion, 'pred',
                              tq._jitted_pred(jm.diffusion)), \
            mock.patch.object(jm.teacher, 'pred',
                              tq._jitted_pred(jm.teacher)):
        res['flux'], draws = _jax_reference(tt._jax_loss_and_grads, cfg,
                                            trainable, frozen, batch)
    inputs['flux'] = dict(cfg=cfg, cfg_dropout=_with_dropout(cfg),
                          trainable=trainable, frozen=frozen, batch=batch,
                          draws=draws)

    # ArcQwen: test_torch_qwen_train.py's tiny pair at 4 heads of 16
    cfg = tq.model_cfg(num_attention_heads=4, attention_head_dim=16,
                       axes_dims_rope=(4, 6, 6))
    trainable, frozen = tq._jax_pair(cfg)
    batch = tq.make_batch(bs=GLOBAL_BS)
    res['qwen'], draws = _jax_reference(tq._jax_loss_and_grads, cfg,
                                        trainable, frozen, batch)
    inputs['qwen'] = dict(cfg=cfg, cfg_dropout=_with_dropout(cfg),
                          trainable=trainable, frozen=tq._f32(frozen),
                          batch=batch, draws=draws)

    torch.save(inputs, os.path.join(tmp, 'inputs.pt'))
    for family in FAMILIES:
        res[family, 'one_dropout'] = sp_step(inputs[family], None, None,
                                             'dropout')
    spawn(_rank_main, RANKS, (tmp,), timeout=120.0)
    res['ranks'] = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                               weights_only=False) for r in range(RANKS)]
    res['ckb_saved'] = tmt.saved_state(os.path.join(
        tmp, 'ckb', 'checkpoints', 'checkerboard_flow'), CKB_ITERS)
    return res


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('family', FAMILIES)
def test_sp_step_matches_jax_single_device(sp_run, family, layout):
    want = sp_run[family]
    got = sp_run['ranks'][0][family, layout, 'replay']
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got['gnorm'], want['gnorm'], rtol=REL_L2)
    assert set(got['adapter']) == set(want['adapter'])
    for n, p in got['adapter'].items():
        before = got['before'][n].numpy()
        err = _rel_l2(p.numpy() - before, want['adapter'][n].numpy() - before)
        assert err <= REL_L2, (n, err)
        np.testing.assert_allclose(got['ema'][n].numpy(),
                                   want['ema'][n].numpy(), **EMA_TOL)


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('family', FAMILIES)
def test_sp_step_with_dropout_is_the_one_device_step(sp_run, family,
                                                     layout):
    """The LoRA dropout masks of a rank's tokens are those tokens' masks of
    the one-device draw (``layers.uniform_rows``), the checkpointed
    recompute included."""
    want = sp_run[family, 'one_dropout']
    got = sp_run['ranks'][0][family, layout, 'dropout']
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    np.testing.assert_allclose(got['gnorm'], want['gnorm'], rtol=1e-4)
    for n, p in got['adapter'].items():
        before = want['before'][n].numpy()
        assert _rel_l2(p.numpy() - before,
                       want['adapter'][n].numpy() - before) <= 1e-4, n
        np.testing.assert_allclose(got['ema'][n].numpy(),
                                   want['ema'][n].numpy(), **EMA_TOL)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_every_rank_holds_rank0_state(sp_run, layout):
    """Losses, norms, gathered adapters and EMAs, both families and both
    variants."""
    ranks = sp_run['ranks']
    for r in ranks[1:]:
        for key in r:
            if key[1] == layout:
                assert _same({k: v for k, v in r[key].items()
                              if k != 'rows'},
                             {k: v for k, v in ranks[0][key].items()
                              if k != 'rows'}), key


def test_ranks_of_an_sp_group_hold_the_same_rows(sp_run):
    """``batch_ranks`` ignores ``sp``: at sp = 4 every rank holds the whole
    batch; at fsdp = 2 x sp = 2 ranks 0-1 and 2-3 (the sp groups, sp
    innermost) hold rows 0 and 1."""
    rows = [r['flux', layout, 'replay']['rows'] for r in sp_run['ranks']
            for layout in ('sp4_ring',)]
    assert rows == [(0, 1)] * RANKS
    rows = [r['flux', 'fsdp2_sp2_ring', 'replay']['rows']
            for r in sp_run['ranks']]
    assert rows == [(0, 2), (0, 2), (1, 2), (1, 2)]


def test_train_model_under_sp_saves_the_state_every_rank_holds(sp_run):
    """``train_model`` on the checkerboard config with ``parallel.mesh``
    data=1 x fsdp=2 x sp=2 (a 3-D mesh; the toy has no attention, so the
    sp group only replicates): every rank's gathered state (parameters,
    EMA, AdamW slots) equals rank 0's and the checkpoint at the last
    iteration, bit for bit."""
    tmt = importlib.import_module('test_torch_mesh_train')
    states = [r['ckb'] for r in sp_run['ranks']]
    for st in states:
        assert tmt.same_state(st, sp_run['ckb_saved'])


def test_attention_gradient_under_local_ring_is_one_device_gradient():
    """``layers.attention`` routed over ``LocalRing(4)`` with a key mask:
    the gradients of q, k and v are the one-device attention's."""
    q, k, v, do, valid = _ring_inputs(3, (20, 48))
    mask = torch.from_numpy(valid)[:, None, None, :]
    grads = []
    for sp in (None, LocalRing(4)):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = t_layers.attention(*leaves, mask=mask, sp=sp)
        grads.append(torch.autograd.grad(out, leaves, torch.from_numpy(do)))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)
