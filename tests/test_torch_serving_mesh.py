"""Port parity for serving over the weight-placing mesh axes:
``ArcFluxPipeline.shard`` over ``data`` / ``fsdp`` (FSDP2 units, the batch
cut over data x fsdp), ``fsdp x tensor``, ``fsdp x sp``, ``pipe`` (a
forward-only pipeline of the stage's blocks), ``expert`` and ``pipe x
expert``, on 4 gloo ranks on the CPU, against the JAX package's
single-device pipeline on the same weights.

The tiny ArcFlux and ArcQwen of ``tests/test_torch_sequence_parallel.py``
and ArcFlux with ``moe_experts=2`` (``tests/test_torch_moe.py``'s routing),
their JAX params drawn from numpy over ``jax.eval_shape`` and carried over;
2-NFE latents of a batch of 2 (Qwen's first row with 3 of 8 text tokens).

* Every rank returns rank 0's latents bit for bit, within rtol 2e-4,
  atol 5e-5 of JAX's (``tests/test_torch_pipeline.py``'s tolerance, fp32).
* A batch that data x fsdp divides is cut (one row a rank at
  ``fsdp=2``); one it does not divide (2 rows on ``fsdp=4``, and batch 1)
  runs whole on every rank (``parallel.mesh.ServingRows``): the port's
  choice for an indivisible batch, where JAX pads the shards.
* What a rank holds: under ``fsdp=n`` each tensor's local part is 1/n of
  it (the parts over the group sum to the whole, quantized kernels
  included), under ``pipe=2`` a rank holds its stage's blocks and no
  other's, under ``expert=2`` half of every expert leaf.
* Qwen-Image w4a8 (int4 kernels in groups of 32, every layer quantized)
  over ``fsdp=4`` is within 4e-3 relative L2 of JAX's w4a8 pipeline
  (``quantize_int4(act_quant=True)``) and bit for bit the port's
  one-process w4a8 pipeline (the batch runs whole on every rank), its
  packed kernels and scales sharded 4 ways. The bound is w4a8's own
  rounding noise on these weights: a per-token int8 activation that
  rounds the other way moves the latents by 1e-3 to 2e-3 (JAX's pipeline
  against itself with its latents scaled by 1 + 1e-7 noise moved 1.1e-3
  to 1.8e-3 in four of six draws; the port is 1.7e-3 to 2.3e-3 from
  JAX; weight-only int4 is 2.3e-6 from JAX), twice the largest of those;
  ``tests/test_torch_qwen_pipeline.py`` holds w4a8 at 1e-3 on weights
  where no activation flips.
* ``data=2 x tensor=2``: one row a data replica, each of a tensor part.
* The serving meshes place rank r where JAX's ``make_mesh`` puts device
  r (8 simulated devices).
* Refused by name on the ranks: MoE blocks under ``tensor`` (item 5.13);
  in one process ``sp`` beside ``pipe`` (5.8), ``fsdp`` beside ``expert``
  (5.10), ``tensor`` beside ``pipe`` (5.12).

JAX runs only in this process; the ranks import no JAX. Each rank runs
``torch.set_num_threads(1)``; the process group is bounded at 60 s and the
spawn at 60 s.
"""

import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from arcflow_tpu_torch.models import ArcFluxTransformer2DModel as TArcFlux
from arcflow_tpu_torch.models import ArcQwenImageTransformer2DModel as TArcQwen
from arcflow_tpu_torch.parallel import setup_distributed, spawn
from arcflow_tpu_torch.parallel.fsdp import local
from arcflow_tpu_torch.pipelines import ArcFluxPipeline, ArcQwenImagePipeline

torch.set_num_threads(1)

RANKS = 4
LAT_TOL = dict(rtol=2e-4, atol=5e-5)
W4A8_REL_L2 = 4e-3
MOE = dict(moe_experts=2, moe_capacity_factor=1.0)
W4A8 = dict(act_quant=True, min_size=1, group_size=32)
# case -> (model, mesh, sp_mode, rows of the batch)
CASES = {
    'fsdp4': ('flux', {'fsdp': 4}, 'ulysses', 2),
    'fsdp4_batch1': ('flux', {'fsdp': 4}, 'ulysses', 1),
    'fsdp2_tensor2': ('flux', {'fsdp': 2, 'tensor': 2}, 'ulysses', 2),
    'data2_tensor2': ('flux', {'data': 2, 'tensor': 2}, 'ulysses', 2),
    'fsdp2_sp2_ring': ('flux', {'fsdp': 2, 'sp': 2}, 'ring', 2),
    'qwen_fsdp2_sp2_ulysses': ('qwen', {'sp': 2, 'fsdp': 2}, 'ulysses', 2),
    'data2_pipe2': ('flux', {'data': 2, 'pipe': 2}, 'ulysses', 2),
    'data2_expert2': ('flux_moe', {'data': 2, 'expert': 2}, 'ulysses', 2),
    'pipe2_expert2': ('flux_moe', {'pipe': 2, 'expert': 2}, 'ulysses', 2),
    'qwen_w4a8_fsdp4': ('qwen_w4a8', {'fsdp': 4}, 'ulysses', 2),
}
# the rows each rank runs: the batch over data x fsdp where it divides
SPLIT = {'fsdp4': False, 'fsdp4_batch1': False, 'fsdp2_tensor2': True,
         'data2_tensor2': True,
         'fsdp2_sp2_ring': True, 'qwen_fsdp2_sp2_ulysses': True,
         'data2_pipe2': True, 'data2_expert2': True,
         'pipe2_expert2': False, 'qwen_w4a8_fsdp4': False}


def _seq():
    return importlib.import_module('test_torch_sequence_parallel')


def _port_model(name):
    seq = _seq()
    if name.startswith('flux'):
        extra = MOE if name == 'flux_moe' else {}
        return TArcFlux(dtype=torch.float32, **seq.FLUX_CFG, **extra), \
            ArcFluxPipeline, seq.PIPE_CFG['flux']
    return TArcQwen(dtype=torch.float32, **seq.QWEN_CFG), \
        ArcQwenImagePipeline, seq.PIPE_CFG['qwen']


def _pipeline(tmp, name):
    """The port's pipeline of model ``name`` with the JAX weights (Qwen's
    quantized to w4a8 for 'qwen_w4a8')."""
    model, cls, cfg = _port_model(name)
    weights = 'qwen' if name == 'qwen_w4a8' else name
    model.load_state_dict(torch.load(os.path.join(tmp, f'{weights}.pt')),
                          strict=True)
    pipe = cls(model, **cfg)
    if name == 'qwen_w4a8':
        pipe.quantize_int4(**W4A8)
    return pipe


def _inputs(tmp, name, rows):
    inputs = torch.load(os.path.join(tmp, 'inputs.pt'))
    family = 'flux' if name.startswith('flux') else 'qwen'
    embeds = {k: v[:rows] for k, v in inputs[family].items()}
    return embeds, inputs['latents'][:rows]


def _sample(pipe, tmp, name, rows):
    embeds, latents = _inputs(tmp, name, rows)
    return pipe(prompt_embeds=embeds, latents=latents,
                output_type='latent')['latents']


def _held(model, one):
    """{name: (local elements, elements of the tensor as placed (a tensor
    part's under ``tensor``), its rows, elements on one device)} of every
    tensor of the state (the quantized buffers included); ``one`` has the
    last, taken before ``shard``."""
    return {n: (local(t).numel(), t.numel(), t.shape[0] if t.dim() else 1,
                one[n]) for n, t in model.state_dict().items()}


def _rank_main(tmp):
    torch.set_num_threads(1)
    setup_distributed('cpu', timeout=60.0)
    out = {}
    for case, (name, axes, mode, rows) in CASES.items():
        pipe = _pipeline(tmp, name)
        one = {n: t.numel() for n, t in pipe.transformer.state_dict().items()}
        pipe.shard(dict(axes), sp_mode=mode, min_size=1)
        lat = _sample(pipe, tmp, name, rows)
        out[case] = dict(latents=lat, held=_held(pipe.transformer, one),
                         split=pipe.rows.splits(rows))
    pipe = _pipeline(tmp, 'flux_moe')
    try:
        pipe.shard({'tensor': RANKS}, min_size=1)
        out['moe_tensor'] = None
    except NotImplementedError as e:
        out['moe_tensor'] = str(e)
    torch.save(out, os.path.join(tmp, f'rank{dist.get_rank()}.pt'))
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
    from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
    from arcflow_tpu.parallel import clear_activation_sharding
    from arcflow_tpu.pipelines import arcflux_pipeline as jpipe
    from arcflow_tpu.utils import quantize as jq
    from arcflow_tpu_torch.pipelines import jax_params_to_torch
    seq = _seq()
    seeded_params = importlib.import_module('test_torch_moe').seeded_params
    tmp = str(tmp_path_factory.mktemp('serving_mesh'))
    # JAX serves on one device: no activation mesh that a JAX test run
    # before in this process (its pipeline's ``shard``) left set
    clear_activation_sharding()
    rng = np.random.default_rng(7)
    f32 = np.float32
    latents = rng.standard_normal((2, 8, 8, 4)).astype(f32)
    mask = np.ones((2, 8), np.int32)
    mask[0, 3:] = 0
    embeds = dict(
        flux=dict(encoder_hidden_states=rng.standard_normal(
            (2, 8, 32)).astype(f32),
            pooled_projections=rng.standard_normal((2, 16)).astype(f32)),
        qwen=dict(encoder_hidden_states=rng.standard_normal(
            (2, 8, 32)).astype(f32), encoder_hidden_states_mask=mask))
    models = dict(
        flux=JArcFlux(patch_size=2, guidance_embeds=True,
                      checkpointing=False, dtype=jnp.float32,
                      **seq.FLUX_CFG),
        flux_moe=JArcFlux(patch_size=2, guidance_embeds=True,
                          checkpointing=False, dtype=jnp.float32,
                          **seq.FLUX_CFG, **MOE),
        qwen=JArcQwen(patch_size=2, checkpointing=False, dtype=jnp.float32,
                      **seq.QWEN_CFG))
    want, params = {}, {}
    for i, (name, jm) in enumerate(models.items()):
        family = 'flux' if name.startswith('flux') else 'qwen'
        fwd = dict(hidden_states=latents, t=np.full((2,), 0.7, f32),
                   **embeds[family])
        if family == 'flux':
            fwd['guidance'] = np.full((2,), 3.5, f32)
        params[name] = seeded_params(jax.eval_shape(
            jm.init, jax.random.PRNGKey(0),
            **{k: jnp.asarray(v) for k, v in fwd.items()})['params'], 10 + i)
        torch.save(jax_params_to_torch(params[name]),
                   os.path.join(tmp, f'{name}.pt'))
        jp = jpipe_cls(jpipe, family)(jm, params[name],
                                      **seq.PIPE_CFG[family])
        variants = [name, 'qwen_w4a8'] if name == 'qwen' else [name]
        for variant in variants:
            try:
                if variant == 'qwen_w4a8':
                    jp.quantize_int4(**W4A8)
                want[variant] = np.asarray(jp(
                    prompt_embeds={k: jnp.asarray(v)
                                   for k, v in embeds[family].items()},
                    latents=jnp.asarray(latents),
                    output_type='latent')['latents'])
            finally:
                jq.set_act_quant(False)     # JAX's process-wide w4a8 flag
    torch.save(dict(latents=torch.from_numpy(latents),
                    **{f: {k: torch.from_numpy(v) for k, v in e.items()}
                       for f, e in embeds.items()}),
               os.path.join(tmp, 'inputs.pt'))
    # the port's one-process w4a8 pipeline, which the sharded one must
    # equal bit for bit
    one = {'qwen_w4a8': _sample(_pipeline(tmp, 'qwen_w4a8'), tmp,
                                'qwen_w4a8', 2)}
    spawn(_rank_main, RANKS, (tmp,), timeout=60.0)
    ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False)
             for r in range(RANKS)]
    return SimpleNamespace(want=want, one=one, ranks=ranks)


def jpipe_cls(jpipe, family):
    return jpipe.ArcFluxPipeline if family == 'flux' \
        else jpipe.ArcQwenImagePipeline


@pytest.mark.parametrize('case', list(CASES))
def test_serving_mesh_matches_jax_and_every_rank_rank0(run, case):
    name, _, _, rows = CASES[case]
    got = run.ranks[0][case]['latents']
    for r in run.ranks[1:]:
        assert torch.equal(r[case]['latents'], got)
    assert run.ranks[0][case]['split'] == SPLIT[case]
    assert tuple(got.shape) == (rows, 8, 8, 4)
    want = np.asarray(run.want[name])[:rows]
    if name == 'qwen_w4a8':
        assert torch.equal(got, run.one[name])
        assert np.linalg.norm(got.numpy() - want) <= \
            W4A8_REL_L2 * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **LAT_TOL)


@pytest.mark.parametrize('case', ['fsdp4', 'fsdp2_tensor2',
                                  'qwen_w4a8_fsdp4'])
def test_fsdp_rank_holds_its_share_of_every_tensor(run, case):
    """Under fsdp=n every tensor's parts over its fsdp group add up to
    the whole and a rank holds at most ceil(rows / n) of its rows (FSDP2
    cuts dim 0); ``fsdp2_tensor2``'s fsdp groups are ranks {0, 2} and
    {1, 3} (JAX's order of ``{'fsdp': 2, 'tensor': 2}``), each of one
    tensor part."""
    n = CASES[case][1]['fsdp']
    groups = [[0, 2], [1, 3]] if n == 2 else [[0, 1, 2, 3]]
    held = [r[case]['held'] for r in run.ranks]
    for name in held[0]:
        for g in groups:
            assert sum(held[r][name][0] for r in g) == held[g[0]][name][1]
            for r in g:
                local_n, whole, rows, _ = held[r][name]
                assert local_n <= -(-rows // n) * (whole // rows), name
    quant = [k for k in held[0] if k.endswith(('kernel_packed4',
                                               'kernel_scale4'))]
    assert bool(quant) == (case == 'qwen_w4a8_fsdp4')


def test_pipe_rank_holds_its_stage_only(run):
    held = [r['data2_pipe2']['held'] for r in run.ranks]
    for stack in ('joint_blocks', 'single_blocks'):
        for i in range(2):
            names = [k for k in held[0] if k.startswith(f'{stack}.{i}.')]
            # ranks 0 / 2 are stage 0, 1 / 3 stage 1 ({'data': 2, 'pipe': 2})
            for rank in range(RANKS):
                mine = (rank % 2) == i
                assert all((held[rank][k][0] > 0) == mine for k in names), \
                    (stack, i, rank)


def test_expert_rank_holds_half_of_every_expert_leaf(run):
    held = run.ranks[0]['data2_expert2']['held']
    leaves = [k for k in held if '.moe.' in k
              and k.rsplit('.', 1)[-1] in ('w_in', 'b_in', 'w_out', 'b_out')]
    assert leaves
    for k in leaves:
        assert held[k][0] * 2 == held[k][3], k


def test_moe_under_tensor_is_refused_by_name_on_the_ranks(run):
    assert all('queue A item 5.13' in r['moe_tensor'] for r in run.ranks)


@pytest.mark.parametrize('axes,item', [
    ({'sp': 2, 'pipe': 2}, '5.8'), ({'fsdp': 2, 'expert': 2}, '5.10'),
    ({'pipe': 2, 'tensor': 2}, '5.12')])
def test_compositions_that_wait_are_refused_by_name(axes, item):
    pipe = ArcFluxPipeline(TArcFlux(dtype=torch.float32,
                                    **_seq().FLUX_CFG))
    with pytest.raises(NotImplementedError, match=rf'queue A item {item}'):
        pipe.shard(axes)


@pytest.mark.parametrize('axes', [{'fsdp': 4, 'tensor': 2},
                                  {'sp': 2, 'fsdp': 4},
                                  {'pipe': 2, 'expert': 2, 'data': 2}])
def test_serving_mesh_places_ranks_as_jax(axes):
    """The serving ``DeviceMesh`` of ``make_mesh(..., serving=True)``
    (the training grid's dimensions) against JAX's ``make_mesh`` on the 8
    simulated devices: rank r where JAX puts device r."""
    import jax
    from arcflow_tpu.parallel import make_mesh as j_make_mesh
    from arcflow_tpu_torch.parallel.mesh import (mesh_axes, mesh_ranks,
                                                 mesh_shape)
    mesh = j_make_mesh(dict(axes))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    sizes = mesh_shape(axes, len(jax.devices()))
    names = list(mesh.shape)
    order = [names.index(a) for a in mesh_axes(sizes) if a in names]
    np.testing.assert_array_equal(
        mesh_ranks(sizes).numpy().reshape(ids.transpose(order).shape),
        ids.transpose(order))
