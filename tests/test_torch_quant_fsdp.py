"""Port parity for the frozen quantized trunk under FSDP2: the int8 and
int4 kernels and their scales (buffers, ``utils/quantize.py``), which
``parallel.shard_model`` shards over ``fsdp`` beside FSDP2's units
(``parallel/fsdp.py:_QuantShards``), as JAX's ``shard_state`` shards
``TrainState.frozen``.

The tiny ArcQwen distillation of ``tests/test_torch_qwen_train.py`` (its
bf16 frozen trunk quantized to int8, or to int4 in groups of 32, the tied
teacher on the student's trunk), JAX's params jittered and carried over,
on 2 gloo ranks at ``fsdp=2`` (one row of a batch of 2 each):

* each rank holds half of the quantized kernels' and scales' elements and
  at most ceil(d / 2) of the d rows or columns of the dimension each is
  cut along (the outermost in memory: the int8 kernel's columns), their
  parts adding up to the whole, in storage of their own (unique storages counted, so a part
  that kept its whole tensor alive would show), and the tied teacher's
  trunk is the student's (sharded once);
* one step (the port's blocks checkpointed, so each gathers its kernels
  again in the recompute and puts them back) with JAX's draws replayed
  against JAX's own step with its
  state placed by ``shard_state`` on a 2-device ``fsdp`` mesh of the
  simulated CPU devices: the loss within 1e-4 relative, the gradient norm
  and each adapter tensor's update within 1e-3 relative L2, the EMA within
  rtol 1e-5, atol 1e-7 (``tests/test_torch_sp_train.py``'s bounds); no
  quantized tensor is in the optimizer, the EMA or the gradient norm, none
  changes in the step, and each is sharded again after it;
* the checkpoint that keeps ``frozen`` (``ckpt_trainable_only=False``),
  gathered from the ranks before the step, is the file one process writes
  of the same state, byte for byte; after the step its ``frozen`` tensors
  equal the one process's bit for bit;
* that one-process checkpoint restored onto fresh ranks puts each rank's
  shard of every frozen tensor back, bit for bit.

JAX runs only in this process; the ranks import no JAX (their helpers
come from JAX-free test modules, the config and weights as files). Each
rank runs ``torch.set_num_threads(1)``; the process group is bounded at
60 s and the spawn at 60 s.
"""

import copy
import importlib
import os
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from arcflow_tpu_torch.models import LatentDiffusionTextImage
from arcflow_tpu_torch.parallel import (make_mesh, setup_distributed,
                                        shard_model, spawn)
from arcflow_tpu_torch.parallel.fsdp import is_sharded, local, shard_of
from arcflow_tpu_torch.parallel.mesh import batch_ranks
from arcflow_tpu_torch.pipelines import load_jax_latent_diffusion
from arcflow_tpu_torch.runner import (CheckpointManager, EmaConfig,
                                      TrainState, build_optimizers,
                                      build_train_step, load_raw_checkpoint)
from arcflow_tpu_torch.utils.quantize import QUANT_NAMES

torch.set_num_threads(1)

RANKS = 2
TRUNKS = ('int8', 'int4')
LOSS_RTOL = 1e-4
REL_L2 = 1e-3
EMA_TOL = dict(rtol=1e-5, atol=1e-7)


def _sp_train():
    return importlib.import_module('test_torch_sp_train')


def _full(t):
    return (t.full_tensor() if is_sharded(t) else t).detach().clone()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _quant(tree):
    return {n: t for n, t in tree.items()
            if n.rsplit('.', 1)[-1] in QUANT_NAMES}


def _rows(tree, index, count):
    if isinstance(tree, dict):
        return {k: _rows(v, index, count) for k, v in tree.items()}
    b = len(tree) // count
    return torch.from_numpy(np.ascontiguousarray(
        tree[index * b:(index + 1) * b]))


def _model(inputs, mesh):
    model = LatentDiffusionTextImage(device='cpu', dtype=torch.float32,
                                     **copy.deepcopy(inputs['cfg']))
    load_jax_latent_diffusion(model, inputs['trainable'], inputs['frozen'])
    if mesh is not None:
        shard_model(model, mesh)
    return model


def quant_step(inputs, mesh, ckpt_dir):
    """One ``build_train_step`` step with JAX's draws replayed, the state
    checkpointed whole (``frozen`` kept) before and after it."""
    sp_train = _sp_train()
    model = _model(inputs, mesh)
    index, count = batch_ranks(mesh) if mesh is not None else (0, 1)
    trainable, frozen = model.init_params()
    base = _quant(frozen['base'])
    student = model.diffusion.denoising
    teacher = model.teacher.denoising
    tied = all(getattr(teacher, c) is getattr(student, c)
               for c in ('transformer_blocks', 'img_in', 'txt_in'))
    storages = {local(t).untyped_storage().data_ptr():
                local(t).untyped_storage().nbytes() for t in base.values()}
    held = dict(
        parts={n: (local(t).numel(), t.numel(),
                   t.shape[t.placements[-1].dim] if is_sharded(t) else 1)
               for n, t in base.items()},
        storage_bytes=sum(storages.values()),
        whole_bytes=sum(t.numel() * t.element_size() for t in base.values()),
        sharded=all(is_sharded(t) for t in base.values()), tied=tied)
    frozen_before = {n: _full(t) for n, t in base.items()}
    optimizers = build_optimizers(copy.deepcopy(sp_train.OPTIMIZER),
                                  trainable)
    opt_ids = {id(p) for o in optimizers.values()
               for g in o.param_groups for p in g['params']}
    state = TrainState.create(torch.Generator().manual_seed(11), trainable,
                              frozen, optimizers, ema_keys=model.ema_keys)
    manager = CheckpointManager(ckpt_dir, interval=1,
                                ckpt_trainable_only=False, async_save=False)
    manager.save(state, force=True)
    step = build_train_step(
        model, optimizers,
        ema_cfg=EmaConfig(momentum_policy='fixed',
                          momentum=sp_train.EMA_MOMENTUM), mesh=mesh)
    rand, randn, rest = sp_train._replaying(inputs['draws'])
    with mock.patch.object(torch, 'rand', rand), \
            mock.patch.object(torch, 'randn', randn):
        state, logs = step(state, _rows(inputs['batch'], index, count))
    assert next(rest, None) is None
    assert state.step == 1
    manager.save(state, force=True)
    manager.close()
    return dict(
        loss=float(logs['loss']), gnorm=float(logs['diffusion_grad_norm']),
        adapter={n: _full(p) for n, p in
                 state.trainable['diffusion'].items()},
        ema={n: _full(p) for n, p in state.ema['diffusion'].items()},
        held=held,
        quant_in_optimizer=any(id(t) in opt_ids for t in base.values()),
        quant_in_ema=any(n in state.ema['diffusion'] for n in base),
        quant_unchanged=all(torch.equal(frozen_before[n], _full(t))
                            for n, t in base.items()),
        # the checkpointed blocks' recompute put every gathered kernel back
        still_sharded=mesh is None or all(
            is_sharded(t) for t in _quant(model.init_params()[1]['base'])
            .values()))


def restore_shards(inputs, mesh, ckpt_dir):
    """A fresh model on the ranks (other weights) restored from
    ``ckpt_dir``: each rank's shard of every quantized tensor against its
    cut of the saved tensor, bit for bit."""
    model = LatentDiffusionTextImage(device='cpu', dtype=torch.float32,
                                     **copy.deepcopy(inputs['cfg']))
    shard_model(model, mesh)
    trainable, frozen = model.init_params()
    optimizers = build_optimizers(copy.deepcopy(_sp_train().OPTIMIZER),
                                  trainable)
    state = TrainState.create(torch.Generator(), trainable, frozen,
                              optimizers, ema_keys=model.ema_keys)
    manager = CheckpointManager(ckpt_dir, ckpt_trainable_only=False)
    manager.restore(state, step=1)
    saved = load_raw_checkpoint(ckpt_dir, 1)['frozen']['base']
    return all(torch.equal(local(t), shard_of(saved[n], t))
               for n, t in _quant(frozen['base']).items())


def _rank_main(tmp):
    torch.set_num_threads(1)
    setup_distributed('cpu', timeout=60.0)
    mesh = make_mesh({'fsdp': RANKS})
    out = {}
    for trunk in TRUNKS:
        inputs = torch.load(os.path.join(tmp, f'{trunk}.pt'),
                            weights_only=False)
        out[trunk] = quant_step(inputs, mesh,
                                os.path.join(tmp, f'ranks_{trunk}'))
        out[trunk]['restored'] = restore_shards(
            inputs, mesh, os.path.join(tmp, f'one_{trunk}'))
    torch.save(out, os.path.join(tmp, f'rank{dist.get_rank()}.pt'))
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    import jax
    from arcflow_tpu.parallel import activation_sharding
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    from arcflow_tpu.parallel import shard_state
    tq = importlib.import_module('test_torch_qwen_train')
    sp_train = _sp_train()
    tmp = str(tmp_path_factory.mktemp('quant_fsdp'))
    want, one = {}, {}
    mesh = j_make_mesh({'fsdp': RANKS}, devices=jax.devices()[:RANKS])
    for trunk in TRUNKS:
        cfg = tq.model_cfg(trunk)
        trainable, frozen = tq._jax_pair(cfg)
        batch = tq.make_batch(bs=RANKS)
        # JAX's own fsdp placement of the whole state, frozen trunk
        # included, with its activations on the same mesh, as JAX's
        # train_model sets them (and not on a mesh that a JAX test run
        # before in this process left set)
        (j_tr, j_fr), _ = shard_state((trainable, frozen), mesh,
                                      min_size=1)
        with activation_sharding(mesh):
            want[trunk], draws = sp_train._jax_reference(
                tq._jax_loss_and_grads, cfg, j_tr, j_fr, batch)
        want[trunk]['sharded'] = [
            jax.tree_util.keystr(p) for p, x in
            jax.tree_util.tree_leaves_with_path(j_fr)
            if x.dtype == np.int8 and not x.sharding.is_fully_replicated]
        # the port's blocks checkpointed (JAX's not: the same numbers), so
        # a sharded block gathers its kernels again in the recompute
        port_cfg = copy.deepcopy(cfg)
        for part in ('diffusion', 'teacher'):
            port_cfg[part]['denoising']['checkpointing'] = True
        inputs = dict(cfg=port_cfg, trainable=trainable,
                      frozen=tq._f32(frozen), batch=batch, draws=draws)
        torch.save(inputs, os.path.join(tmp, f'{trunk}.pt'))
        one[trunk] = quant_step(inputs, None, os.path.join(tmp,
                                                           f'one_{trunk}'))
    spawn(_rank_main, RANKS, (tmp,), timeout=60.0)
    ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False)
             for r in range(RANKS)]
    return SimpleNamespace(want=want, one=one, ranks=ranks, tmp=tmp)


@pytest.mark.parametrize('trunk', TRUNKS)
def test_each_rank_holds_half_of_the_quantized_trunk(run, trunk):
    assert run.want[trunk]['sharded']       # JAX shards them too
    held = [r[trunk]['held'] for r in run.ranks]
    assert all(h['sharded'] and h['tied'] for h in held)
    for name, (_, whole, d) in held[0]['parts'].items():
        parts = [h['parts'][name][0] for h in held]
        assert sum(parts) == whole, name
        assert max(parts) <= -(-d // RANKS) * (whole // d), name
    for h in held:
        assert h['storage_bytes'] <= 0.5 * h['whole_bytes'] + \
            sum(whole // d for _, whole, d in h['parts'].values()) * 4


@pytest.mark.parametrize('trunk', TRUNKS)
def test_sharded_step_matches_jax_shard_state_step(run, trunk):
    want = run.want[trunk]
    for r in run.ranks:
        got = r[trunk]
        assert got['loss'] == run.ranks[0][trunk]['loss']
        np.testing.assert_allclose(got['loss'], want['loss'],
                                   rtol=LOSS_RTOL)
        assert _rel_l2(got['gnorm'], want['gnorm']) < REL_L2
        for n, w in want['adapter'].items():
            assert _rel_l2(got['adapter'][n].numpy(), w) < REL_L2, n
            np.testing.assert_allclose(got['ema'][n].numpy(),
                                       want['ema'][n], **EMA_TOL)
        assert not got['quant_in_optimizer'] and not got['quant_in_ema']
        assert got['quant_unchanged'] and got['still_sharded']


@pytest.mark.parametrize('trunk', TRUNKS)
def test_gathered_checkpoint_is_one_devices_byte_for_byte(run, trunk):
    def path(who, step):
        return os.path.join(run.tmp, f'{who}_{trunk}', str(step), 'state.pt')
    with open(path('ranks', 0), 'rb') as a, open(path('one', 0), 'rb') as b:
        assert a.read() == b.read()
    ranks = load_raw_checkpoint(os.path.join(run.tmp, f'ranks_{trunk}'), 1)
    one = load_raw_checkpoint(os.path.join(run.tmp, f'one_{trunk}'), 1)
    for k, sub in one['frozen'].items():
        assert sub.keys() == ranks['frozen'][k].keys()
        for n, t in sub.items():
            assert torch.equal(ranks['frozen'][k][n], t), n
            assert ranks['frozen'][k][n].dtype == t.dtype


@pytest.mark.parametrize('trunk', TRUNKS)
def test_restore_puts_each_ranks_shard_back(run, trunk):
    assert all(r[trunk]['restored'] for r in run.ranks)
