"""Port parity for the ``tensor`` mesh axis (``parallel/tensor.py``): the
Megatron-style split of the FLUX and Qwen blocks, in serving (``tensor``,
``sp x tensor``) and in training beside ``data`` / ``fsdp`` under FSDP2, on
the CPU, against the JAX package.

* ``LoRADense`` in column and row form (one segment, and the two segments
  of a single block's ``proj_out``) on ``LocalTensor(2/4)`` in every mode
  (fp32, int8, w8a8, int4, w4a8, groups of 32), with LoRA and its dropout
  from per-row generators, against the same layer on one device: rtol
  1e-5, atol 1e-5 (fp32 sums in another order; the quantized activations
  are the same, since a row layer's per-token scale is the max over the
  shards); the input's and the adapter's gradients of the fp32 layer
  within the same bounds.
* Two planted faults a wrong split would make: a single block's
  ``proj_out`` rows taken as one contiguous 1/t (not its heads' rows and
  its hidden units' rows) moves the block's output by more than 10x the
  sound split's error; a row-parallel w8a8 layer quantizing each shard by
  its own absmax moves the output beyond the 1e-5 bound the sound split
  keeps.
* The tiny ArcFlux and ArcQwen of ``tests/test_torch_sequence_parallel.py``
  (4 heads of 16, JAX params jittered and carried over), forward and 2-NFE
  pipeline, on ``LocalTensor(2)`` and ``LocalTensor(4)`` in one process and
  on 4 gloo ranks at ``tensor=4`` and ``sp=2 x tensor=2`` (ring and
  Ulysses), every layer split (``min_size=1``): against JAX's one-device
  forward at rtol 2e-3, atol 2e-4 and its latents at rtol 2e-4, atol 5e-5
  (that file's tolerances), and against JAX's own ``{'data': 2, 'fsdp':
  2, 'tensor': 2}`` program on the 8 simulated CPU devices
  (``tests/test_pipelines.py:288``; ArcFlux) within the same latent
  tolerance.
  Every rank returns rank 0's output bit for bit, and a rank holds 1/t of
  each split layer.
* The tiny ArcQwen distillation step with its int8 frozen trunk (the int8
  kernels split after quantizing), on 4 gloo ranks at ``fsdp=2 x
  tensor=2``, with JAX's draws replayed: loss within 1e-4 relative,
  gradient norm and each adapter tensor's update within 1e-3 relative L2,
  the EMA within rtol 1e-5, atol 1e-7, against JAX's single-device
  ``value_and_grad``, optax's AdamW and the JAX EMA
  (``tests/test_torch_sp_train.py``'s bounds). The tiny ArcFlux step (1 +
  1 blocks) with LoRA dropout and checkpointing, at ``fsdp=2 x tensor=2``
  and ``data=2 x tensor=2``, equals the port's one-process step (loss rtol
  1e-5, updates 1e-4 relative L2), which ``tests/test_torch_mesh_train.py``
  and ``tests/test_torch_sp_train.py`` hold against JAX's (its JAX
  reference costs 30 s of compile here, which this file leaves to them).
* ``train_model`` with ``parallel = dict(mesh=dict(fsdp=2, tensor=2),
  tensor_axis='tensor', min_shard_size=1)`` on the tiny ArcFlux: its first
  iteration's loss and adapter equal the one-process ``train_model``'s on
  the same global batch (loss rtol 1e-5, adapter rtol 1e-5, atol 1e-7);
  its checkpoint restores in one process bit for bit, and one process's
  checkpoint restores onto the mesh bit for bit.

JAX runs only in this process; the ranks import no JAX (the rank function
lives here at module level and the module imports JAX only inside
functions). Each rank runs ``torch.set_num_threads(1)``; the process group
is bounded at 60 s and the spawn at 150 s.
"""

import contextlib
import copy
import importlib
import os
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from arcflow_tpu_torch.models import ArcFluxTransformer2DModel as TArcFlux
from arcflow_tpu_torch.models import ArcQwenImageTransformer2DModel as TArcQwen
from arcflow_tpu_torch.models import LatentDiffusionTextImage
from arcflow_tpu_torch.models.flux import FluxSingleBlock
from arcflow_tpu_torch.models.layers import LoRADense
from arcflow_tpu_torch.parallel import (LocalTensor, make_mesh,
                                        set_tensor_parallel,
                                        setup_distributed, shard_model, spawn)
from arcflow_tpu_torch.parallel import tensor as tensor_par
from arcflow_tpu_torch.parallel.fsdp import is_sharded
from arcflow_tpu_torch.parallel.mesh import batch_ranks
from arcflow_tpu_torch.pipelines import (ArcFluxPipeline, ArcQwenImagePipeline,
                                         load_jax_latent_diffusion)
from arcflow_tpu_torch.registry import DATASETS
from arcflow_tpu_torch.runner import (EmaConfig, TrainState,
                                      build_optimizers, build_train_step)
from arcflow_tpu_torch.utils.quantize import (quantize_weights_int4,
                                              quantize_weights_int8)

torch.set_num_threads(1)

RANKS = 4
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=2e-3, atol=2e-4)
LAT_TOL = dict(rtol=2e-4, atol=5e-5)
LOSS_RTOL = 1e-4
REL_L2 = 1e-3
EMA_TOL = dict(rtol=1e-5, atol=1e-7)
HEADS = ('means', 'logweights', 'loggammas')
FAMILIES = ('flux', 'qwen')
# serving on the gloo ranks: (mesh, sp_mode)
SERVING = {'tensor4': ({'tensor': 4}, 'ulysses'),
           'sp2_tensor2_ring': ({'sp': 2, 'tensor': 2}, 'ring'),
           'sp2_tensor2_ulysses': ({'sp': 2, 'tensor': 2}, 'ulysses')}
TRAINING = {'fsdp2_tensor2': dict(data=1, fsdp=2, tensor=2),
            'data2_tensor2': dict(data=2, fsdp=1, tensor=2)}
LOCAL_SIZES = (2, 4)
MODES = ('float', 'int8', 'w8a8', 'int4', 'w4a8')
FORMS = {'column': ('column', (64,)), 'row': ('row', (256,)),
         'row_two_segments': ('row', (128, 128))}


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _full(t):
    return (t.full_tensor() if is_sharded(t) else t).detach().clone()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---- LoRADense in column and row form --------------------------------------------

def _layer(mode, in_f, out_f, seed=0):
    torch.manual_seed(seed)
    layer = LoRADense(in_f, out_f, lora_rank=4, lora_dropout=0.2,
                      dtype=torch.float32)
    with torch.no_grad():
        layer.bias.normal_()
        layer.lora_b.normal_()
    holder = torch.nn.Module()
    holder.layer = layer
    if mode in ('int8', 'w8a8'):
        quantize_weights_int8(holder, min_size=1, act_quant=mode == 'w8a8')
    elif mode in ('int4', 'w4a8'):
        quantize_weights_int4(holder, min_size=1, group_size=32,
                              act_quant=mode == 'w4a8')
    return layer


def _generators(seed, rows=2):
    return [torch.Generator().manual_seed(seed + r) for r in range(rows)]


def _split_case(mode, form, size):
    kind, segments = FORMS[form]
    in_f, out_f = (128, 64) if kind == 'column' else (256, 64)
    one = _layer(mode, in_f, out_f)
    split = copy.deepcopy(one)
    split.split_tensor(LocalTensor(size), kind, segments)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, in_f)).astype(
        np.float32))
    x[:, :, :in_f // 2] *= 4.0       # the halves' absmax differ
    return one, split, x, kind, segments


def _run_split(split, x, kind, segments, size, generator):
    if kind == 'column':
        return torch.cat(split(x, generator), dim=-1)
    parts = [tensor_par.take(x, -1, tensor_par.part_ranges(segments, size, i))
             for i in range(size)]
    return split(parts, generator)


@pytest.mark.parametrize('size', LOCAL_SIZES)
@pytest.mark.parametrize('form', list(FORMS))
@pytest.mark.parametrize('mode', MODES)
def test_lora_dense_split_matches_one_device(mode, form, size):
    one, split, x, kind, segments = _split_case(mode, form, size)
    want = one(x, _generators(5))
    got = _run_split(split, x, kind, segments, size, _generators(5))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **LAYER_TOL)
    if mode != 'float':
        return
    xs = [x.clone().requires_grad_() for _ in range(2)]
    grads = []
    for layer, xi in ((one, xs[0]), (split, xs[1])):
        out = layer(xi, _generators(9)) if layer is one else \
            _run_split(layer, xi, kind, segments, size, _generators(9))
        w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        grads.append(torch.autograd.grad(
            (out * w).sum(), [xi, layer.lora_a, layer.lora_b]))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **LAYER_TOL)


def test_split_keeps_the_quantized_kernels_whole_then_cut():
    """A row split of an int4 layer cuts whole scale groups and keeps the
    packed bytes: the shards' parts put together are the layer's buffers
    bit for bit (never re-quantized)."""
    layer = _layer('w4a8', 256, 64)
    whole = {n: layer._buffers[n].clone() for n in
             ('kernel_packed4', 'kernel_scale4')}
    layer.split_tensor(LocalTensor(4), 'row', (128, 128))
    for n, t in whole.items():
        parts = layer._tensor_parts[n]
        assert all(p.is_contiguous() for p in parts)
        assert torch.equal(tensor_par.join_parts(parts, n, 'row', (128, 128),
                                                 32), t)


def _single_block(size, seed=0):
    torch.manual_seed(seed)
    block = FluxSingleBlock(64, 4, 16, dtype=torch.float32)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.1 * torch.randn_like(p))
    split = copy.deepcopy(block)
    set_tensor_parallel(split, LocalTensor(size), min_size=1)
    return block, split


def _block_inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 12, 64, generator=g)
    temb = torch.randn(2, 64, generator=g)
    cos, sin = torch.ones(12, 16), torch.zeros(12, 16)
    return x, (cos, sin), temb


def test_planted_contiguous_proj_out_rows_are_caught():
    """A single block's ``proj_out`` shard reads its heads' rows and its
    hidden units' rows; one contiguous 1/t of the rows (the likeliest
    silent fault) moves the block's output far beyond the sound split's
    error."""
    block, split = _single_block(2)
    x, rope, temb = _block_inputs()
    with torch.no_grad():
        want = block(x, rope, temb)
        sound = split(x, rope, temb)

        def contiguous(segments, size, i):
            n = sum(segments) // size
            return [(i * n, n)]
        with mock.patch.object(tensor_par, 'part_ranges', contiguous):
            planted = split(x, rope, temb)
    sound_err = (sound - want).abs().max().item()
    assert sound_err <= 1e-5
    assert (planted - want).abs().max().item() > 10 * max(sound_err, 1e-4)


def test_planted_per_shard_absmax_is_caught():
    """A row-parallel w8a8 layer takes the per-token scale over the whole
    row (an all-reduce max); each shard's own absmax quantizes another
    way and leaves the 1e-5 bound the sound split keeps."""
    one, split, x, kind, segments = _split_case('w8a8', 'row', 2)
    with torch.no_grad():
        want = one(x)
        sound = _run_split(split, x, kind, segments, 2, None)
        with mock.patch.object(LocalTensor, 'all_max',
                               lambda self, xs: xs):
            planted = _run_split(split, x, kind, segments, 2, None)
    np.testing.assert_allclose(sound.numpy(), want.numpy(), **LAYER_TOL)
    assert (planted - want).abs().max().item() > 100 * LAYER_TOL['atol']


# ---- the mesh and the refusals ----------------------------------------------------

@pytest.mark.parametrize('axes', [{'data': 2, 'fsdp': 2, 'tensor': 2},
                                  {'tensor': 2, 'fsdp': -1, 'data': 1},
                                  {'sp': 2, 'tensor': 4},
                                  {'tensor': 4, 'sp': 2}])
def test_mesh_with_tensor_places_ranks_as_jax(axes):
    """The training grid ('data', 'fsdp', 'tensor') and the serving
    ``sp x tensor`` order against JAX's ``make_mesh`` on the 8 simulated
    devices: rank r where JAX puts device r."""
    import jax
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    from arcflow_tpu_torch.parallel.mesh import mesh_ranks, mesh_shape
    mesh = j_make_mesh(dict(axes))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    sizes = mesh_shape(axes, len(jax.devices()))
    if set(axes) <= {'sp', 'tensor'}:
        want = np.arange(8).reshape(tuple(sizes.values()))
        np.testing.assert_array_equal(want, ids)
        return
    names = list(mesh.shape)
    order = [names.index(a) for a in ('data', 'fsdp', 'tensor')]
    np.testing.assert_array_equal(mesh_ranks(sizes).numpy(),
                                  ids.transpose(order))


def test_one_process_serving_mesh_with_tensor():
    assert make_mesh({'tensor': 1}) == {'tensor': None}
    assert make_mesh({'sp': 1, 'tensor': -1}) == {'sp': None, 'tensor': None}
    with pytest.raises(ValueError, match='!= 1 devices'):
        make_mesh({'tensor': 2})


@pytest.mark.parametrize('axes,item', [
    ({'data': 1, 'fsdp': 1, 'sp': 2, 'tensor': 2}, '5.11'),
    ({'data': 1, 'fsdp': 1, 'pipe': 2, 'tensor': 2}, '5.12'),
    ({'data': 1, 'fsdp': 1, 'expert': 2, 'tensor': 2}, '5.12')])
def test_compositions_that_wait_are_refused_by_name(axes, item):
    with pytest.raises(NotImplementedError, match=rf'queue A item {item}'):
        make_mesh(axes)


def test_moe_blocks_under_tensor_are_refused_by_name():
    model = TArcFlux(dtype=torch.float32, moe_experts=2,
                     **_seq().FLUX_CFG)
    with pytest.raises(NotImplementedError, match='queue A item 5.13'):
        set_tensor_parallel(model, LocalTensor(2), min_size=1)


# serving takes fsdp, pipe, expert and data beside tensor now
# (tests/test_torch_serving_mesh.py); each case is a composition of those
# axes that still waits, with its item, refused before any mesh is made
@pytest.mark.parametrize('axes', [(dict(fsdp=2, pipe=2), '5.10'),
                                  (dict(pipe=2, tensor=2), '5.12'),
                                  (dict(expert=2, sp=2), '5.8'),
                                  (dict(expert=2, tensor=2), '5.12')])
def test_serving_refuses_the_other_weight_axes(axes):
    refused, item = axes
    pipe = ArcFluxPipeline(TArcFlux(dtype=torch.float32, **_seq().FLUX_CFG))
    with pytest.raises(NotImplementedError, match=rf'queue A item {item}'):
        pipe.shard(refused)


def test_ulysses_under_tensor_needs_the_local_heads_to_divide():
    with pytest.raises(ValueError, match='use sp_mode="ring"'):
        tensor_par.check_ulysses_heads(4, 2, 4)
    tensor_par.check_ulysses_heads(8, 2, 4)


def test_min_size_keeps_small_units_whole():
    """JAX's rule: a leaf below ``min_size`` elements (counted over its
    block stack) stays replicated; the port keeps such a unit whole. At
    the tiny width every unit is below the default 2^16."""
    model = TArcFlux(dtype=torch.float32, **_seq().FLUX_CFG)
    assert set_tensor_parallel(copy.deepcopy(model), LocalTensor(2)) == 0
    assert set_tensor_parallel(copy.deepcopy(model), LocalTensor(2),
                               min_size=1) > 0
    # a layer of 64 x 256 in a stack of 2 holds 32768 elements: below
    # 2^15 + 1 its unit splits, above it stays whole
    big = set_tensor_parallel(copy.deepcopy(model), LocalTensor(2),
                              min_size=2 ** 15)
    small = set_tensor_parallel(copy.deepcopy(model), LocalTensor(2),
                                min_size=2 ** 15 + 1)
    assert big > small


# ---- the models: one process and 4 gloo ranks ---------------------------------------

def _seq():
    return importlib.import_module('test_torch_sequence_parallel')


def _family(name):
    seq = _seq()
    return dict(flux=(TArcFlux, ArcFluxPipeline, seq.FLUX_CFG),
                qwen=(TArcQwen, ArcQwenImagePipeline, seq.QWEN_CFG))[name]


def _serve(tmp, family, split):
    """(forward heads, 2-NFE latents) of a family's model from its JAX
    weights, after ``split(pipe)``."""
    seq = _seq()
    inputs = torch.load(os.path.join(tmp, 'inputs.pt'))[family]
    cls, pipe_cls, cfg = _family(family)
    model = cls(dtype=torch.float32, **cfg)
    model.load_state_dict(torch.load(os.path.join(tmp, f'{family}.pt')),
                          strict=True)
    pipe = pipe_cls(model, **seq.PIPE_CFG[family])
    split(pipe)
    with torch.no_grad():
        fwd = model(**inputs['forward'])
    lat = pipe(prompt_embeds=inputs['embeds'], latents=inputs['latents'],
               output_type='latent')['latents']
    # the bytes of the blocks' storage: a part that shared its whole
    # tensor's storage would keep the whole in memory
    held = sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for n, t in model.state_dict().items()
                if '_blocks.' in n or 'transformer_blocks.' in n}.values())
    return dict(forward={k: fwd[k] for k in HEADS}, latents=lat, held=held)


# ---- training ------------------------------------------------------------------------

def _rows(tree, index, count):
    def rows(x):
        b = len(x) // count
        return torch.from_numpy(np.ascontiguousarray(
            x[index * b:(index + 1) * b]))
    return _map(rows, tree)


def _replaying(draws):
    return importlib.import_module('test_torch_sp_train')._replaying(draws)


def tp_step(fam, mesh, variant):
    """One ``build_train_step`` step of a family's tiny distillation on
    ``mesh`` (None: one process): 'replay' with JAX's draws and no
    dropout, 'dropout' with LoRA dropout and checkpointing from the port's
    own generator."""
    from arcflow_tpu_torch.parallel.tensor import partition_tensor
    sp_train = importlib.import_module('test_torch_sp_train')
    cfg = fam['cfg' if variant == 'replay' else 'cfg_dropout']
    torch.manual_seed(0)
    model = LatentDiffusionTextImage(device='cpu', dtype=torch.float32,
                                     **copy.deepcopy(cfg))
    if 'trainable' in fam:
        load_jax_latent_diffusion(model, fam['trainable'], fam['frozen'])
    else:
        _jitter_all(model, fam['seed'])
    mp = None
    if mesh is not None:
        mp = partition_tensor(model, mesh, min_size=1)
        shard_model(model, mesh)
    index, count = batch_ranks(mesh) if mesh is not None else (0, 1)
    trainable, frozen = model.init_params()

    def whole(name, t):
        return _full(t) if mp is None else mp.gather_full(name, t.detach())
    before = {n: whole(n, p) for n, p in trainable['diffusion'].items()}
    optimizers = build_optimizers(copy.deepcopy(sp_train.OPTIMIZER),
                                  trainable)
    state = TrainState.create(torch.Generator().manual_seed(11), trainable,
                              frozen, optimizers, ema_keys=model.ema_keys)
    state.model_parallel = mp
    step = build_train_step(
        model, optimizers,
        ema_cfg=EmaConfig(momentum_policy='fixed', momentum=0.9), mesh=mesh)
    batch = _rows(fam['batch'], index, count)
    if variant == 'replay':
        rand, randn, rest = _replaying(fam['draws'])
        with mock.patch.object(torch, 'rand', rand), \
                mock.patch.object(torch, 'randn', randn):
            state, logs = step(state, batch)
        assert next(rest, None) is None
    else:
        state, logs = step(state, batch)

    out = dict(loss=float(logs['loss']), before=before,
               gnorm=float(logs['diffusion_grad_norm']),
               adapter={n: whole(n, p) for n, p in
                        state.trainable['diffusion'].items()},
               ema={n: whole(n, p) for n, p in state.ema['diffusion'].items()})
    if mp is not None:
        out['split'] = sorted(n for n in state.trainable['diffusion']
                              if n in mp.splits)
    return out


@DATASETS.register_module()
class TensorTestPromptEmbeds:
    """A batch of the tiny ArcFlux's prompt embeds from the loader's
    generator (``chip_smoke.py:SmokePromptEmbeds`` at the tiny widths)."""

    def __init__(self, latent_size=(8, 8, 4)):
        self.latent_size = tuple(latent_size)

    def __len__(self):
        return 1

    def batch(self, rng, n):
        return dict(
            latents=np.zeros((n, *self.latent_size), np.float32),
            prompt_embed_kwargs=dict(
                encoder_hidden_states=rng.standard_normal(
                    (n, 6, 32), dtype=np.float32),
                pooled_projections=rng.standard_normal(
                    (n, 16), dtype=np.float32)))


def train_cfg(mesh=None, samples=1):
    """The FLUX distillation config at the tiny ArcFlux's widths (1 + 1
    blocks, LoRA rank 4, dropout and checkpointing on), one iteration, a
    trainable-only checkpoint at it; ``mesh`` with ``tensor_axis``."""
    from arcflow_tpu_torch.config import Config
    tmt = importlib.import_module('test_torch_mesh_train')
    cfg = Config.fromfile(os.path.join(tmt.REPO,
                                       'configs/flux/arcflux_2nfe_k16.py'))
    net = dict(tmt.TINY_NET, num_single_layers=1, checkpointing=True)
    opts = {f'model.{k}.denoising.{f}': v for k in ('diffusion', 'teacher')
            for f, v in net.items()}
    opts.update({'model.diffusion.denoising.num_gaussians': 4,
                 'model.diffusion.denoising.lora_rank': 4,
                 'model.latent_shape': (8, 8, 4), 'model.text_embed_dim': 32,
                 'model.pooled_dim': 16, 'model.frozen_dtype': 'float32',
                 'train_cfg.num_intermediate_states': 2,
                 'data.train': dict(_delete_=True,
                                    type='TensorTestPromptEmbeds'),
                 'data.train_dataloader.samples_per_gpu': samples,
                 'evaluation': None, 'total_iters': 1,
                 'checkpoint_config': dict(_delete_=True, interval=1,
                                           trainable_only=True),
                 'log_config.interval': 1})
    cfg.merge_from_dict(opts)
    if mesh is None:
        cfg.merge_from_dict({'parallel': dict(_delete_=True)})
    else:
        cfg.merge_from_dict({'parallel': dict(
            _delete_=True, mesh=mesh, fsdp_axis='fsdp', tensor_axis='tensor',
            min_shard_size=1)})
    return cfg


def _train_model(cfg, work):
    """``train_model`` for one iteration: the adapter after it (gathered to
    the one-device layout) and the mesh."""
    from arcflow_tpu_torch.apis import train as t_train
    state, _ = t_train.train_model(cfg, work_dir=work, device='cpu',
                                   max_iters=1, seed=3)
    mp = state.model_parallel
    return dict(adapter={n: _full(p) if mp is None else
                         mp.gather_full(n, p.detach())
                         for n, p in state.trainable['diffusion'].items()},
                mesh=None if mp is None else
                dict(zip(mp.mesh.mesh_dim_names, mp.mesh.shape)))


@contextlib.contextmanager
def _joined_rows(count):
    """One process's loader yields the global batch of ``count`` batch
    ranks: their rows concatenated (``chip_smoke.py:joined_rows``)."""
    from arcflow_tpu_torch.apis import train as t_train
    real = t_train.build_dataloader

    def build(dataset, samples, num_replicas=1, rank=0, **kwargs):
        its = [real(dataset, samples // count, num_replicas=count, rank=r,
                    **kwargs) for r in range(count)]

        def gen():
            while True:
                parts = [next(it) for it in its]
                yield _map_many(lambda *x: np.concatenate(x), parts)
        return gen()
    with mock.patch.object(t_train, 'build_dataloader', build):
        yield


def _map_many(fn, trees):
    if isinstance(trees[0], dict):
        return {k: _map_many(fn, [t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def _rank_main(tmp):
    torch.set_num_threads(1)
    setup_distributed('cpu', timeout=60.0)
    rank = dist.get_rank()
    out = {}
    for name, (axes, mode) in SERVING.items():
        for family in FAMILIES:
            out[family, name] = _serve(
                tmp, family, lambda p: p.shard(dict(axes), sp_mode=mode,
                                               min_size=1))
    inputs = torch.load(os.path.join(tmp, 'train.pt'), weights_only=False)
    for name, axes in TRAINING.items():
        mesh = make_mesh(dict(axes))
        if name == 'fsdp2_tensor2':
            out['qwen', name, 'replay'] = tp_step(inputs['qwen'], mesh,
                                                  'replay')
        out['flux', name, 'dropout'] = tp_step(inputs['flux'], mesh,
                                               'dropout')
    # train_model on fsdp=2 x tensor=2, then a fresh mesh run resumed from
    # the one-process checkpoint
    work = os.path.join(tmp, 'mesh_run')
    out['train_model'] = _train_model(train_cfg(dict(fsdp=2, tensor=2)),
                                      work)
    resumed = train_cfg(dict(fsdp=2, tensor=2))
    resumed.merge_from_dict({'total_iters': 1})
    from arcflow_tpu_torch.apis import train as t_train
    with mock.patch.object(t_train.IterBasedRunner, 'run',
                           lambda self: self.state):
        state, _ = t_train.train_model(
            resumed, work_dir=os.path.join(tmp, 'one_run'), device='cpu',
            seed=3)
    mp = state.model_parallel
    out['restored_one'] = {n: mp.gather_full(n, p.detach()) for n, p in
                           state.trainable['diffusion'].items()}
    if rank == 0:
        torch.save(out, os.path.join(tmp, 'rank0.pt'))
    else:
        torch.save({k: v for k, v in out.items()
                    if k[0] in FAMILIES and k[1] in SERVING},
                   os.path.join(tmp, f'rank{rank}.pt'))
    dist.destroy_process_group()


def _jitter_all(model, seed):
    """Every float tensor of the composition's denoisers moved by 0.05 x a
    normal draw from ``seed`` (random AdaLN gates are zero until drawn),
    in name order, so every process draws alike."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for root in model.fsdp_modules().values():
            for _, t in sorted(root.state_dict(keep_vars=True).items()):
                if t.is_floating_point():
                    t.add_(0.05 * torch.randn(t.shape, generator=g))


def _with_dropout(cfg):
    return importlib.import_module('test_torch_sp_train')._with_dropout(cfg)


@pytest.fixture(scope='module')
def tp_run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
    from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
    from arcflow_tpu.parallel import clear_activation_sharding
    from arcflow_tpu.pipelines import arcflux_pipeline as jpipe
    from arcflow_tpu_torch.pipelines import jax_params_to_torch
    seq = _seq()
    sp_train = importlib.import_module('test_torch_sp_train')
    tq = importlib.import_module('test_torch_qwen_train')
    tmt = importlib.import_module('test_torch_mesh_train')
    tmp = str(tmp_path_factory.mktemp('tensor'))
    rng = np.random.default_rng(5)
    f32 = np.float32
    latents = rng.standard_normal((2, 8, 8, 4)).astype(f32)
    inputs, want = {}, {}
    j_models = dict(
        flux=(JArcFlux(guidance_embeds=True, patch_size=2,
                       checkpointing=False, dtype=jnp.float32,
                       **seq.FLUX_CFG), jpipe.ArcFluxPipeline),
        qwen=(JArcQwen(patch_size=2, checkpointing=False, dtype=jnp.float32,
                       **seq.QWEN_CFG), jpipe.ArcQwenImagePipeline))
    for family in FAMILIES:
        mask = np.ones((2, 8), np.int32)
        mask[0, 3:] = 0
        txt = rng.standard_normal((2, 8, 32)).astype(f32)
        embeds = dict(encoder_hidden_states=txt,
                      pooled_projections=rng.standard_normal(
                          (2, 16)).astype(f32)) if family == 'flux' else \
            dict(encoder_hidden_states=txt, encoder_hidden_states_mask=mask)
        forward = dict(hidden_states=latents, t=np.full((2,), 0.7, f32),
                       **embeds)
        if family == 'flux':
            forward['guidance'] = np.full((2,), 3.5, f32)
        jm, jpipe_cls = j_models[family]
        j_fwd = {n: jnp.asarray(x) for n, x in forward.items()}
        params = seq._jitter(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                              **j_fwd)['params'], rng)
        torch.save(jax_params_to_torch(params),
                   os.path.join(tmp, f'{family}.pt'))
        out = jax.jit(jm.apply)({'params': params}, **j_fwd)
        j_embeds = {n: jnp.asarray(x) for n, x in embeds.items()}
        lat = jpipe_cls(jm, params, **seq.PIPE_CFG[family])(
            prompt_embeds=j_embeds, latents=jnp.asarray(latents),
            output_type='latent')['latents']
        want[family] = dict(forward={k: np.asarray(out[k]) for k in HEADS},
                            latents=np.asarray(lat))
        if family == 'flux':
            jp = jpipe_cls(jm, params, **seq.PIPE_CFG[family])
            try:
                jp.shard({'data': 2, 'fsdp': 2, 'tensor': 2}, min_size=1)
                want[family]['latents_jax_tensor'] = np.asarray(jp(
                    prompt_embeds=j_embeds, latents=jnp.asarray(latents),
                    output_type='latent')['latents'])
            finally:
                clear_activation_sharding()

        def torch_dict(d):
            return {n: torch.from_numpy(np.asarray(x)) for n, x in d.items()}
        inputs[family] = dict(forward=torch_dict(forward),
                              embeds=torch_dict(embeds),
                              latents=torch.from_numpy(latents))
    torch.save(inputs, os.path.join(tmp, 'inputs.pt'))

    # the distillation steps: ArcFlux at 1 + 1 blocks (the port's weights
    # and draws), ArcQwen at 4 heads of 16 with its int8 frozen trunk
    # (JAX's weights, JAX's draws replayed)
    train = {}
    cfg = tmt.arcflux_cfg()
    for part in ('diffusion', 'teacher'):
        cfg[part]['denoising']['num_single_layers'] = 1
    train['flux'] = dict(cfg_dropout=_with_dropout(cfg), seed=7,
                         batch=tmt.arcflux_batch(rows=2))
    cfg = tq.model_cfg('int8', num_attention_heads=4, attention_head_dim=16,
                       axes_dims_rope=(4, 6, 6))
    trainable, frozen = tq._jax_pair(cfg)
    batch = tq.make_batch(bs=2)
    want['qwen', 'step'], draws = sp_train._jax_reference(
        tq._jax_loss_and_grads, cfg, trainable, frozen, batch)
    train['qwen'] = dict(cfg=cfg, cfg_dropout=_with_dropout(cfg),
                         trainable=trainable, frozen=tq._f32(frozen),
                         batch=batch, draws=draws)
    torch.save(train, os.path.join(tmp, 'train.pt'))

    local = {}
    for size in LOCAL_SIZES:
        for family in FAMILIES:
            local[family, size] = _serve(
                tmp, family, lambda p: set_tensor_parallel(
                    p.transformer, LocalTensor(size), min_size=1))
    one = {f: _serve(tmp, f, lambda p: None) for f in FAMILIES}
    one_dropout = tp_step(train['flux'], None, 'dropout')
    # one process through train_model on the ranks' global batch: its
    # checkpoint is the one the ranks restore
    with _joined_rows(2):
        one_run = _train_model(train_cfg(samples=2),
                               os.path.join(tmp, 'one_run'))
    spawn(_rank_main, RANKS, (tmp,), timeout=150.0)
    ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False)
             for r in range(RANKS)]
    from arcflow_tpu_torch.runner.checkpoint import load_raw_checkpoint
    saved = load_raw_checkpoint(os.path.join(
        tmp, 'mesh_run', 'checkpoints', 'arcflux_2nfe_k16'), 1)
    return SimpleNamespace(want=want, ranks=ranks, local=local, one=one,
                           one_dropout=one_dropout, one_run=one_run,
                           saved=saved, noise=latents)


@pytest.mark.parametrize('size', LOCAL_SIZES)
@pytest.mark.parametrize('family', FAMILIES)
def test_local_tensor_forward_and_pipeline_match_jax(tp_run, family, size):
    got, want = tp_run.local[family, size], tp_run.want[family]
    for key in HEADS:
        np.testing.assert_allclose(got['forward'][key].numpy(),
                                   want['forward'][key], err_msg=key,
                                   **FWD_TOL)
    assert np.abs(got['latents'].numpy() - tp_run.noise).max() > 0.1
    np.testing.assert_allclose(got['latents'].numpy(), want['latents'],
                               **LAT_TOL)


@pytest.mark.parametrize('family', ['flux'])
def test_local_tensor_matches_jax_tensor_program(tp_run, family):
    """Against JAX's own ``{'data': 2, 'fsdp': 2, 'tensor': 2}`` program
    on the simulated CPU mesh, which itself matches its one-device
    program (ArcFlux; its compile costs seconds a family)."""
    want = tp_run.want[family]['latents_jax_tensor']
    np.testing.assert_allclose(want, tp_run.want[family]['latents'],
                               **LAT_TOL)
    np.testing.assert_allclose(tp_run.local[family, 2]['latents'].numpy(),
                               want, **LAT_TOL)


CELLS = [(f, s) for f in FAMILIES for s in SERVING]


@pytest.mark.parametrize('family,layout', CELLS)
def test_sharded_serving_matches_jax(tp_run, family, layout):
    want = tp_run.want[family]
    got = tp_run.ranks[0][family, layout]
    for key in HEADS:
        np.testing.assert_allclose(got['forward'][key].numpy(),
                                   want['forward'][key], err_msg=key,
                                   **FWD_TOL)
    np.testing.assert_allclose(got['latents'].numpy(), want['latents'],
                               **LAT_TOL)


@pytest.mark.parametrize('family,layout', CELLS)
def test_every_rank_returns_rank0_output_and_holds_its_part(tp_run, family,
                                                            layout):
    first = tp_run.ranks[0][family, layout]
    for res in tp_run.ranks[1:]:
        got = res[family, layout]
        assert torch.equal(got['latents'], first['latents'])
        for key in HEADS:
            assert torch.equal(got['forward'][key], first['forward'][key])
    # every block layer is split: a rank holds 1 / t of the blocks'
    # weights, but for the norms and the row layers' biases
    t = SERVING[layout][0]['tensor']
    whole = tp_run.one[family]['held']
    assert whole / t <= first['held'] < 1.1 * whole / t


def test_fsdp_tensor_int8_trunk_step_matches_jax_single_device(tp_run):
    want = tp_run.want['qwen', 'step']
    got = tp_run.ranks[0]['qwen', 'fsdp2_tensor2', 'replay']
    assert got['split'], 'no adapter tensor is split'
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got['gnorm'], want['gnorm'], rtol=REL_L2)
    assert set(got['adapter']) == set(want['adapter'])
    for n, p in got['adapter'].items():
        before = got['before'][n].numpy()
        err = _rel_l2(p.numpy() - before, want['adapter'][n].numpy() - before)
        assert err <= REL_L2, (n, err)
        np.testing.assert_allclose(got['ema'][n].numpy(),
                                   want['ema'][n].numpy(), **EMA_TOL)


@pytest.mark.parametrize('layout', list(TRAINING))
def test_tensor_step_with_dropout_is_the_one_process_step(tp_run, layout):
    """LoRA dropout masks drawn at the full width and cut per shard, and
    checkpointing: the one-process step."""
    want = tp_run.one_dropout
    got = tp_run.ranks[0]['flux', layout, 'dropout']
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    np.testing.assert_allclose(got['gnorm'], want['gnorm'], rtol=1e-4)
    for n, p in got['adapter'].items():
        before = want['before'][n].numpy()
        assert _rel_l2(p.numpy() - before,
                       want['adapter'][n].numpy() - before) <= 1e-4, n


def test_train_model_on_fsdp_tensor_is_the_one_process_run(tp_run):
    got = tp_run.ranks[0]['train_model']
    assert got['mesh'] == {'data': 1, 'fsdp': 2, 'tensor': 2}
    want = tp_run.one_run['adapter']
    assert set(got['adapter']) == set(want)
    for n, p in got['adapter'].items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_mesh_checkpoint_restores_in_one_process(tp_run):
    """The fsdp=2 x tensor=2 run's checkpoint holds the one-device layout:
    every adapter tensor at its full shape, equal to the ranks' gathered
    state bit for bit."""
    got = tp_run.ranks[0]['train_model']['adapter']
    saved = tp_run.saved['trainable']['diffusion']
    assert set(saved) == set(got)
    for n, t in saved.items():
        assert torch.equal(t, got[n]), n
    assert saved['joint_blocks.0.ff_img.in_proj.lora_b'].shape == (4, 256)
    assert saved['single_blocks.0.proj_out.lora_a'].shape == (64 + 256, 4)


def test_one_process_checkpoint_restores_on_the_mesh(tp_run):
    """A checkpoint written in one process restores onto fsdp=2 x
    tensor=2: each rank's parts gathered back are the saved tensors."""
    got = tp_run.ranks[0]['restored_one']
    assert set(got) == set(tp_run.one_run['adapter'])
    for n, t in got.items():
        assert torch.equal(t, tp_run.one_run['adapter'][n]), n
