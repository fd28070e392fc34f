"""Port parity for sequence-parallel serving: ``ArcFluxPipeline.shard({'sp':
4}, sp_mode=...)`` on 4 gloo ranks on the CPU, in ring and Ulysses mode,
against the JAX package's unsharded model and pipeline.

The tiny ArcFlux of tests/test_ring_attention.py (guidance embeds on, as
the port's FLUX always has them) and a tiny ArcQwen whose first sample's
text mask pads 5 of 8 tokens (so under ring whole text shards of that row
are padded blocks) get jittered JAX params, carried over to the port. The
``_t7`` families give the same models 7 text tokens, which 4 ranks do not
divide: the trunks pad the stream with masked tokens (as the 990-token Qwen
prompt at sp = 4 needs), and the result is still the unsharded one. JAX
runs only in this process: the weights and the inputs go to the ranks as
files in a temporary directory, and the ranks write their outputs back.
The rank function lives here at module level and the module imports JAX
only inside the fixture, so the ranks import no JAX. Each rank runs
``torch.set_num_threads(1)``; the process group and the join are bounded
(60 s and 120 s), so a hang fails the test instead of the suite.

Tolerances, all fp32: the sharded forward against the JAX forward rtol
2e-3, atol 2e-4 (tests/test_ring_attention.py's own for the sharded JAX
forward); the 2-NFE latents rtol 2e-4, atol 5e-5 (tests/test_torch_pipeline
.py's); every rank's output equal to rank 0's, and shard r of the real
ring equal to shard r of ``LocalRing`` on the same inputs, bit for bit.
"""

import os
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from arcflow_tpu_torch.models import ArcFluxTransformer2DModel as TArcFlux
from arcflow_tpu_torch.models import ArcQwenImageTransformer2DModel as TArcQwen
from arcflow_tpu_torch.models import layers as t_layers
from arcflow_tpu_torch.parallel import (LocalRing, SequenceParallel,
                                        make_mesh, ring_attention,
                                        setup_distributed, spawn)
from arcflow_tpu_torch.pipelines import ArcFluxPipeline, ArcQwenImagePipeline

torch.set_num_threads(1)

RANKS = 4
MODES = ('ring', 'ulysses')
FLUX_CFG = dict(in_channels=16, num_layers=2, num_single_layers=2,
                attention_head_dim=16, num_attention_heads=4,
                joint_attention_dim=32, pooled_projection_dim=16,
                axes_dims_rope=(4, 6, 6), num_gaussians=4)
QWEN_CFG = dict(in_channels=16, num_layers=2, attention_head_dim=16,
                num_attention_heads=4, joint_attention_dim=32,
                axes_dims_rope=(4, 6, 6), max_text_len=8, num_gaussians=4,
                lora_rank=4)
FAMILIES = {'flux': (TArcFlux, ArcFluxPipeline, FLUX_CFG),
            'qwen': (TArcQwen, ArcQwenImagePipeline, QWEN_CFG)}
FAMILIES.update({f'{f}_t7': v for f, v in FAMILIES.items()})
TEXT_LEN = {f: 7 if f.endswith('_t7') else 8 for f in FAMILIES}
PIPE_CFG = dict(flux=dict(shift=3.2, nfe=2, temperature=0.7,
                          guidance_scale=3.5),
                qwen=dict(shift=3.1, nfe=2, temperature=0.7))
FWD_TOL = dict(rtol=2e-3, atol=2e-4)
LAT_TOL = dict(rtol=2e-4, atol=5e-5)
HEADS = ('means', 'logweights', 'loggammas')


def _rank_main(tmp):
    """One rank: both families, both modes; writes ``rank{r}.pt``."""
    torch.set_num_threads(1)
    setup_distributed('cpu', timeout=60.0)
    rank = dist.get_rank()
    inputs = torch.load(os.path.join(tmp, 'inputs.pt'))
    results = {}
    for family, (cls, pipe_cls, cfg) in FAMILIES.items():
        kind = family.split('_')[0]
        model = cls(dtype=torch.float32, **cfg)
        model.load_state_dict(torch.load(os.path.join(tmp, f'{kind}.pt')),
                              strict=True)
        pipe = pipe_cls(model, **PIPE_CFG[kind])
        fwd_in, embeds, latents = (inputs[family][n] for n in
                                   ('forward', 'embeds', 'latents'))
        for mode in MODES:
            pipe.shard({'sp': RANKS}, sp_mode=mode)
            calls = []

            def spy(*args, **kw):
                out = ring_attention(*args, **kw)
                calls.append((*args[:4], out))
                return out
            with torch.no_grad(), mock.patch.object(
                    t_layers, 'ring_attention', spy):
                fwd = model(**fwd_in)
            lat = pipe(prompt_embeds=embeds, latents=latents,
                       output_type='latent')['latents']
            results[family, mode] = dict(
                forward={k: fwd[k] for k in HEADS}, latents=lat,
                first_ring_call=calls[0] if calls else None)
    sp = SequenceParallel(mode='ulysses')
    try:
        sp.seq_to_heads(torch.zeros(1, 2, 3, 16))
        results['ulysses_3_heads'] = None
    except ValueError as e:
        results['ulysses_3_heads'] = str(e)
    torch.save(results, os.path.join(tmp, f'rank{rank}.pt'))
    dist.destroy_process_group()


def _jitter(params, rng):
    import jax
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(params))


@pytest.fixture(scope='module')
def sp_run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from arcflow_tpu.models import ArcFluxTransformer2DModel as JArcFlux
    from arcflow_tpu.models import ArcQwenImageTransformer2DModel as JArcQwen
    from arcflow_tpu.pipelines import arcflux_pipeline as jpipe
    from arcflow_tpu_torch.pipelines import jax_params_to_torch

    tmp = str(tmp_path_factory.mktemp('sp'))
    rng = np.random.default_rng(5)
    f32 = np.float32
    latents = rng.standard_normal((2, 8, 8, 4)).astype(f32)
    embeds, forward = {}, {}
    for family, n_txt in TEXT_LEN.items():
        mask = np.ones((2, n_txt), np.int32)
        mask[0, 3:] = 0
        txt = rng.standard_normal((2, n_txt, 32)).astype(f32)
        embeds[family] = dict(
            encoder_hidden_states=txt,
            pooled_projections=rng.standard_normal((2, 16)).astype(f32)) \
            if family.startswith('flux') else \
            dict(encoder_hidden_states=txt, encoder_hidden_states_mask=mask)
        forward[family] = dict(hidden_states=latents,
                               t=np.full((2,), 0.7, f32), **embeds[family])
        if family.startswith('flux'):
            forward[family]['guidance'] = np.full((2,), 3.5, f32)
    j_models = dict(
        flux=(JArcFlux(guidance_embeds=True, patch_size=2,
                       checkpointing=False, dtype=jnp.float32,
                       **FLUX_CFG), jpipe.ArcFluxPipeline),
        qwen=(JArcQwen(patch_size=2, checkpointing=False, dtype=jnp.float32,
                       **QWEN_CFG), jpipe.ArcQwenImagePipeline))
    want, params = {}, {}
    for family in FAMILIES:
        kind = family.split('_')[0]
        jm, jpipe_cls = j_models[kind]
        j_fwd = {n: jnp.asarray(x) for n, x in forward[family].items()}
        if kind not in params:
            params[kind] = _jitter(jax.jit(jm.init)(
                jax.random.PRNGKey(0), **j_fwd)['params'], rng)
            torch.save(jax_params_to_torch(params[kind]),
                       os.path.join(tmp, f'{kind}.pt'))
        out = jax.jit(jm.apply)({'params': params[kind]}, **j_fwd)
        jp = jpipe_cls(jm, params[kind], **PIPE_CFG[kind])
        lat = jp(prompt_embeds={n: jnp.asarray(x) for n, x in
                                embeds[family].items()},
                 latents=jnp.asarray(latents),
                 output_type='latent')['latents']
        want[family] = dict(forward={k: np.asarray(out[k]) for k in HEADS},
                            latents=np.asarray(lat))

    def torch_dict(d):
        return {n: torch.from_numpy(np.asarray(x)) for n, x in d.items()}
    torch.save({family: dict(forward=torch_dict(forward[family]),
                             embeds=torch_dict(embeds[family]),
                             latents=torch.from_numpy(latents))
                for family in FAMILIES}, os.path.join(tmp, 'inputs.pt'))
    spawn(_rank_main, RANKS, (tmp,), timeout=120.0)
    ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'))
             for r in range(RANKS)]
    return SimpleNamespace(want=want, ranks=ranks, noise=latents)


CELLS = [(f, m) for f in FAMILIES for m in MODES]


@pytest.mark.parametrize('family,mode', CELLS)
def test_sharded_forward_matches_jax(sp_run, family, mode):
    want = sp_run.want[family]['forward']
    for r, res in enumerate(sp_run.ranks):
        got = res[family, mode]['forward']
        for key in HEADS:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       err_msg=f'rank {r} {key}', **FWD_TOL)


@pytest.mark.parametrize('family,mode', CELLS)
def test_sharded_pipeline_matches_jax(sp_run, family, mode):
    want = sp_run.want[family]['latents']
    got = sp_run.ranks[0][family, mode]['latents'].numpy()
    assert got.shape == want.shape == sp_run.noise.shape
    assert np.abs(got - sp_run.noise).max() > 0.1      # the sampler moved x
    np.testing.assert_allclose(got, want, **LAT_TOL)


@pytest.mark.parametrize('family,mode', CELLS)
def test_every_rank_returns_rank0_output(sp_run, family, mode):
    first = sp_run.ranks[0][family, mode]
    for res in sp_run.ranks[1:]:
        assert torch.equal(res[family, mode]['latents'], first['latents'])
        for key in HEADS:
            assert torch.equal(res[family, mode]['forward'][key],
                               first['forward'][key])


@pytest.mark.parametrize('family', list(FAMILIES))
def test_real_ring_shard_equals_local_ring_shard(sp_run, family):
    """The first ring attention of the forward (a joint block; for Qwen
    with its text mask): rank r's output is shard r of ``LocalRing(4)`` on
    the ranks' q, k, v and key mask put together, bit for bit."""
    calls = [res[family, 'ring']['first_ring_call'] for res in sp_run.ranks]
    assert all(c is not None for c in calls)
    q, k, v = (torch.cat([c[i] for c in calls], dim=1) for i in range(3))
    mask = None if calls[0][3] is None else \
        torch.cat([c[3] for c in calls], dim=1)
    # FLUX runs unmasked unless its text stream was padded
    assert (mask is None) == (family == 'flux')
    local = ring_attention(q, k, v, mask, LocalRing(RANKS))
    for r, c in enumerate(calls):
        assert torch.equal(local.split(c[0].shape[1], dim=1)[r], c[4]), r
    assert all(res[family, 'ulysses']['first_ring_call'] is None
               for res in sp_run.ranks)


def test_ulysses_needs_heads_divisible_by_sp(sp_run):
    for res in sp_run.ranks:
        assert 'use sp_mode="ring"' in res['ulysses_3_heads']


def test_mesh_takes_only_the_sp_axis():
    """A serving mesh takes ``sp`` alone or beside ``tensor``
    (``tests/test_torch_tensor_parallel.py``), JAX's device count
    holding: one process refuses ``tensor=2``."""
    with pytest.raises(ValueError, match='!= 1 devices'):
        make_mesh({'sp': 1, 'tensor': 2})
    assert make_mesh({'sp': 1, 'tensor': 1}) == {'sp': None, 'tensor': None}
    with pytest.raises(ValueError, match='every process'):
        make_mesh({'sp': 4})                 # one process here
    assert make_mesh({'sp': -1}) == {'sp': None}


@pytest.mark.parametrize('axis', ['tensor', 'pipe', 'expert'])
def test_training_mesh_with_sp_refuses_waiting_axes(axis):
    """``sp`` beside ``data`` / ``fsdp`` trains (a 3-D mesh,
    ``tests/test_torch_sp_train.py``); ``tensor``, which trains beside
    ``data`` / ``fsdp``, is refused beside ``sp`` in training with the
    item of that composition, and ``pipe`` and ``expert`` (which train
    beside ``data`` / ``fsdp``) with the item of theirs."""
    from arcflow_tpu_torch.parallel.mesh import (SP_WITH_MODEL_AXES,
                                                 TENSOR_WITH_SP_TRAINING)
    item = TENSOR_WITH_SP_TRAINING if axis == 'tensor' \
        else SP_WITH_MODEL_AXES
    with pytest.raises(NotImplementedError, match=rf"'{axis}'.*item {item}"):
        make_mesh({'data': 1, 'fsdp': -1, 'sp': 1, axis: 2})


def test_sharding_one_process_keeps_one_device():
    pipe = ArcFluxPipeline(TArcFlux(dtype=torch.float32, **FLUX_CFG))
    pipe.shard({'sp': 1}, sp_mode='ring')
    assert all(getattr(m, 'sequence_parallel', None) is None
               for m in pipe.transformer.modules())


def test_shard_refuses_weight_sharding_size():
    """``min_size`` sizes the ``tensor`` split (JAX's rule), so ``shard``
    takes it; with ``sp`` alone nothing is split. ``fsdp`` shards weights
    beside ``sp`` by FSDP2's rule (``tests/test_torch_serving_mesh.py``),
    where ``min_size`` does not apply; in one process ``fsdp=2`` does not
    meet the device count and is refused as JAX refuses it."""
    pipe = ArcFluxPipeline(TArcFlux(dtype=torch.float32, **FLUX_CFG))
    assert pipe.shard({'sp': 1}, min_size=2 ** 16) == {'sp': None}
    assert all(getattr(m, 'tensor_split', None) is None
               for m in pipe.transformer.modules())
    with pytest.raises(ValueError, match='!= 1 devices'):
        pipe.shard({'sp': 1, 'fsdp': 2}, min_size=2 ** 16)


def test_setup_distributed_wants_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '1')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        setup_distributed()
