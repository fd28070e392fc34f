"""Port parity: the export (``arcflow_tpu_torch/export_arcflow_to_diffusers.py``)
and the tools (``arcflow_tpu_torch/tools``) against the JAX package's
``export_arcflow_to_diffusers.py`` and ``tools/*``.

The same adapter goes into each package's own checkpoint: a tiny ArcFlux's
jittered JAX params into an Orbax checkpoint through JAX's
``CheckpointManager``, the same params through ``jax_params_to_torch`` into
the port's ``state.pt``. Then:

* the exports: the same keys and tensors bit for bit, the same
  ``policy_config`` metadata and ``config.json``;
* ``save_inference_weights``: JAX's file (flax paths, bf16) and the port's
  (``state_dict`` keys, bf16) hold the same values, bit for bit, once JAX's
  are carried over with ``jax_params_to_torch``;
* the Comfy LoRA converter: bit for bit against JAX's on a seeded BFL
  state at FLUX's widths;
* ``count_parameters``: the same printout as JAX's on a toy config, the
  model built on the ``meta`` device and on the CPU;
* ``checkpoint_cleaner``: the same steps removed as JAX's;
* ``cache_image_prompt_data`` with tiny CLIP and T5 towers: its records
  read back through JAX's ``ImagePrompt`` and the port's equal, and equal
  to a direct encoder pass;
* ``cache_imagenet_data_sdvae``: its records read back through
  ``ImageNet`` as the encoder's latents; JAX's records of the same tool
  read back transposed (ROADMAP queue C);
* ``validate_toy_e2e`` runs both stages through ``train_model`` at a few
  iterations.
"""

import contextlib
import functools
import gzip
import io
import json
import os
import runpy
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from safetensors import safe_open

from arcflow_tpu_torch.pipelines import jax_params_to_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(in_channels=16, num_layers=2, num_single_layers=3,
            attention_head_dim=32, num_attention_heads=4,
            joint_attention_dim=64, pooled_projection_dim=32,
            axes_dims_rope=(8, 12, 12), guidance_embeds=True,
            checkpointing=False)


@contextlib.contextmanager
def argv(*args):
    with mock.patch.object(sys, 'argv', list(args)):
        yield


def run_script(path, *args):
    """A JAX-package script's ``main`` in this process; its stdout."""
    out = io.StringIO()
    with argv(path, *args), contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(REPO, path), run_name='__main__')
    return out.getvalue()


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """(JAX checkpoint dir, port checkpoint dir, config path, the JAX
    trainable and EMA adapter trees) of one tiny ArcFlux adapter."""
    from arcflow_tpu.models import (ARCFLUX_ADAPTER_KEYS,
                                    ArcFluxTransformer2DModel)
    from arcflow_tpu.runner import CheckpointManager, TrainState
    from arcflow_tpu.utils.pytree import partition_params
    d = tmp_path_factory.mktemp('export')
    student = ArcFluxTransformer2DModel(num_gaussians=4, patch_size=2,
                                        lora_rank=4, dtype=jnp.float32,
                                        **TINY)
    inputs = dict(hidden_states=jnp.zeros((1, 8, 8, 4)), t=jnp.zeros((1,)),
                  encoder_hidden_states=jnp.zeros((1, 6, 64)),
                  pooled_projections=jnp.zeros((1, 32)),
                  guidance=jnp.zeros((1,)))
    params = jax.device_get(jax.jit(student.init)(jax.random.PRNGKey(3),
                                                  **inputs)['params'])
    adapter, _ = partition_params(params, ARCFLUX_ADAPTER_KEYS)
    rng = np.random.default_rng(0)
    adapter = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
        np.shape(x)).astype(np.float32), adapter)
    ema = jax.tree.map(lambda x: x + np.float32(0.01), adapter)
    state = TrainState.create(jax.random.PRNGKey(4), {'diffusion': adapter},
                              {}, {'diffusion': optax.adamw(1e-4)},
                              ema_keys=('diffusion',))
    state = state.replace(step=jnp.asarray(5, jnp.int32),
                          ema={'diffusion': ema})
    mgr = CheckpointManager(str(d / 'jax_ck'), interval=1)
    assert mgr.save(state)
    mgr.close()
    port_dir = d / 'port_ck' / '5'
    port_dir.mkdir(parents=True)
    torch.save(dict(step=5,
                    trainable={'diffusion': jax_params_to_torch(adapter)},
                    ema={'diffusion': jax_params_to_torch(ema)},
                    optimizers={}, generator=torch.Generator().get_state()),
               str(port_dir / 'state.pt'))
    cfg_py = d / 'cfg.py'
    cfg_py.write_text(
        'model = dict(type="LatentDiffusionTextImage", diffusion=dict(\n'
        '    type="ArcFlowImitationDataFree", policy_type="ArcFlow",\n'
        '    denoising=dict(type="ArcFluxTransformer2DModel", patch_size=2,\n'
        f'                   num_gaussians=4, lora_rank=4,\n'
        f'                   pretrained="/nonexistent",\n'
        f'                   pretrained_adapter="/nonexistent", **{TINY!r})))\n'
        'test_cfg = dict(nfe=2, timestep_ratio=0.5, total_substeps=64)\n')
    return (str(d / 'jax_ck'), str(d / 'port_ck'), str(cfg_py), adapter,
            ema)


def _read(path):
    with safe_open(path, framework='np') as f:
        return {k: f.get_tensor(k) for k in f.keys()}, f.metadata()


@pytest.mark.parametrize('no_ema', [False, True])
def test_export_equals_jax(tmp_path, checkpoints, no_ema):
    from arcflow_tpu_torch.export_arcflow_to_diffusers import main
    j_ck, t_ck, cfg_py, _, _ = checkpoints
    flag = ['--no-ema'] if no_ema else []
    run_script('export_arcflow_to_diffusers.py', cfg_py, j_ck,
               str(tmp_path / 'jax'), *flag)
    main([cfg_py, t_ck, str(tmp_path / 'port'), *flag])
    name = 'diffusion_pytorch_model.safetensors'
    want, want_meta = _read(str(tmp_path / 'jax' / name))
    got, got_meta = _read(str(tmp_path / 'port' / name))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_meta == want_meta
    assert json.loads(got_meta['policy_config']) == dict(
        policy_type='ArcFlow', nfe=2, timestep_ratio=0.5, total_substeps=64,
        num_gaussians=4)
    j_cfg = json.load(open(tmp_path / 'jax' / 'config.json'))
    t_cfg = json.load(open(tmp_path / 'port' / 'config.json'))
    assert t_cfg == j_cfg
    assert t_cfg['_class_name'] == 'ArcFluxTransformer2DModel'
    assert 'pretrained' not in t_cfg and 'pretrained_adapter' not in t_cfg


def test_exported_adapter_serves_the_ema(tmp_path, checkpoints):
    """The exported file loads into a pipeline as the checkpoint's EMA."""
    from arcflow_tpu_torch.export_arcflow_to_diffusers import export
    from arcflow_tpu_torch.pipelines import load_adapter_state
    _, t_ck, cfg_py, _, ema = checkpoints
    policy = export(cfg_py, t_ck, str(tmp_path / 'out'))
    state, got_policy = load_adapter_state(
        str(tmp_path / 'out' / 'diffusion_pytorch_model.safetensors'))
    assert got_policy == policy
    want = jax_params_to_torch(ema)
    assert state.keys() == want.keys()
    for k in want:
        assert torch.equal(state[k], want[k]), k


def test_save_inference_weights_equals_jax(tmp_path, checkpoints):
    from arcflow_tpu.utils.pytree import unflatten
    from arcflow_tpu_torch.tools.save_inference_weights import main
    j_ck, t_ck, _, _, _ = checkpoints
    out = run_script('tools/save_inference_weights.py', j_ck,
                     str(tmp_path / 'jax.safetensors'))
    assert 'params' in out
    main([t_ck, str(tmp_path / 'port.safetensors')])
    want, _ = _read(str(tmp_path / 'jax.safetensors'))
    with safe_open(str(tmp_path / 'port.safetensors'), framework='pt') as f:
        got = {k: f.get_tensor(k) for k in f.keys()}
    tree = unflatten({k: v.astype(np.float32) for k, v in want.items()})
    want = {f'diffusion.{k}': v for k, v in
            jax_params_to_torch(tree['diffusion']).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.bfloat16, k
        assert torch.equal(got[k].float(), want[k]), k
    # --no-ema --dtype float32: the live adapter as it is
    main([t_ck, str(tmp_path / 'live.safetensors'), '--no-ema', '--dtype',
          'float32'])
    with safe_open(str(tmp_path / 'live.safetensors'), framework='pt') as f:
        live = {k: f.get_tensor(k) for k in f.keys()}
    adapter = checkpoints[3]
    for k, v in jax_params_to_torch(adapter).items():
        assert torch.equal(live[f'diffusion.{k}'], v), k


def _bfl_lora(seed=0, rank=4, heads=24, head_dim=128):
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    shapes = {'img_attn_qkv': (3 * d, d), 'img_attn_proj': (d, d),
              'txt_mlp_0': (4 * d, d), 'img_mod_lin': (6 * d, d)}
    single = {'linear1': (3 * d + 4 * d, d), 'linear2': (d, d + 4 * d),
              'modulation_lin': (3 * d, d)}
    state = {}
    for kind, table in (('double', shapes), ('single', single)):
        for module, (out_dim, in_dim) in table.items():
            base = f'lora_unet_{kind}_blocks_1_{module}'
            state[f'{base}.lora_down.weight'] = rng.standard_normal(
                (rank, in_dim)).astype(np.float16)
            state[f'{base}.lora_up.weight'] = rng.standard_normal(
                (out_dim, rank)).astype(np.float16)
            if module != 'img_attn_proj':
                state[f'{base}.alpha'] = np.asarray(2.0, np.float32)
    return state


def test_comfy_lora_converter_equals_jax(tmp_path):
    from safetensors.numpy import save_file

    from arcflow_tpu_torch.tools import convert_comfy_flux_lora_to_diffusers \
        as port
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        jax_tool = __import__('convert_comfy_flux_lora_to_diffusers')
    finally:
        sys.path.pop(0)
    state = _bfl_lora()
    want = jax_tool.convert_comfy_flux_lora(state)
    got = port.convert_comfy_flux_lora(state)
    assert got.keys() == want.keys()
    assert len(got) == 2 * (3 + 1 + 1 + 1 + 4 + 1 + 1)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    src = str(tmp_path / 'in.safetensors')
    save_file(state, src)
    port.main([src, str(tmp_path / 'port.safetensors')])
    jax_tool.main(src, str(tmp_path / 'jax.safetensors'))
    a, _ = _read(str(tmp_path / 'port.safetensors'))
    b, _ = _read(str(tmp_path / 'jax.safetensors'))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(KeyError, match='unrecognized'):
        port.convert_comfy_flux_lora({'lora_te_x.alpha': np.ones(())})


def test_count_parameters_prints_what_jax_prints(tmp_path, capsys):
    from arcflow_tpu_torch.tools.count_parameters import (count_parameters,
                                                          main)
    cfg = tmp_path / 'toy.py'
    cfg.write_text(
        f"_base_ = ['{REPO}/configs/toy/checkerboard_arcflow_2nfe.py']\n"
        "model = dict(teacher_ckpt=None)\n")
    want = run_script('tools/count_parameters.py', str(cfg))
    main([str(cfg)])
    assert capsys.readouterr().out == want
    assert count_parameters(str(cfg), 'cpu') == \
        count_parameters(str(cfg), 'meta')
    assert 'trainable: ' in want and 'frozen: ' in want


def test_checkpoint_cleaner_removes_what_jax_removes(tmp_path):
    from arcflow_tpu_torch.tools.checkpoint_cleaner import main
    steps = [100, 200, 300, 400, 500, 1000]
    for side in ('jax', 'port'):
        for s in steps:
            os.makedirs(tmp_path / side / str(s))
        (tmp_path / side / 'latest.txt').write_text('1000')
    run_script('tools/checkpoint_cleaner.py', str(tmp_path / 'jax'),
               '--keep-last', '2', '--keep-every', '200')
    main([str(tmp_path / 'port'), '--keep-last', '2', '--keep-every',
          '200'])
    assert sorted(os.listdir(tmp_path / 'port')) == \
        sorted(os.listdir(tmp_path / 'jax')) == \
        ['1000', '200', '400', '500', 'latest.txt']
    main([str(tmp_path / 'port'), '--keep-last', '1', '--dry-run'])
    assert len(os.listdir(tmp_path / 'port')) == 5


@pytest.fixture(scope='module')
def towers(tmp_path_factory):
    """Tiny CLIP-L-like and T5-like folders with a trained tokenizer."""
    import transformers as tf

    from test_torch_qwen_text import write_tokenizer
    root = tmp_path_factory.mktemp('towers')
    clip, t5 = str(root / 'clip'), str(root / 't5')
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        tf.CLIPTextModel(tf.CLIPTextConfig(
            vocab_size=240, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=77)).save_pretrained(clip)
        tf.T5EncoderModel(tf.T5Config(
            vocab_size=240, d_model=48, d_kv=8, d_ff=64, num_layers=2,
            num_heads=2)).save_pretrained(t5)
    for d, cfg in ((clip, dict(tokenizer_class='CLIPTokenizer',
                              bos_token='<|startoftext|>',
                              eos_token='<|endoftext|>', unk_token='<unk>',
                              pad_token='<|endoftext|>',
                              model_max_length=77)),
                   (t5, dict(tokenizer_class='T5Tokenizer', eos_token='</s>',
                             unk_token='<unk>', pad_token='<pad>'))):
        write_tokenizer(d)
        if d == clip:                         # CLIP's own BPE
            os.remove(os.path.join(d, 'tokenizer.json'))
        with open(os.path.join(d, 'tokenizer_config.json'), 'w') as fh:
            json.dump(cfg, fh)
    return clip, t5


PROMPTS = ['a photo of a cat sitting on a mat', 'the quick brown fox',
           'describe the image']


def test_cache_image_prompt_data_reads_back_in_both_packages(
        tmp_path, towers):
    from arcflow_tpu.data import ImagePrompt as JImagePrompt
    from arcflow_tpu_torch.data import ImagePrompt
    from arcflow_tpu_torch.models import PretrainedFluxTextEncoder
    from arcflow_tpu_torch.tools.cache_image_prompt_data import main
    clip, t5 = towers
    plist = tmp_path / 'prompts.jsonl'
    plist.write_text(''.join(json.dumps({'prompt': p}) + '\n'
                             for p in PROMPTS))
    out = str(tmp_path / 'cache')
    main(['--prompts', str(plist), '--out', out, '--family', 'flux',
          '--height', '64', '--width', '48', '--max-seq-len', '8',
          '--batch', '2', '--clip-path', clip, '--t5-path', t5,
          '--device', 'cpu'])
    dl = os.path.join(out, 'datalist.jsonl.gz')
    with gzip.open(dl, 'rt') as f:
        names = [json.loads(line)['name'] for line in f]
    assert names == ['00000000', '00000001', '00000002']
    enc = PretrainedFluxTextEncoder(clip_path=clip, t5_path=t5,
                                    max_sequence_length=8, device='cpu')
    direct = enc(PROMPTS)
    for test_mode in (False, True):
        kw = dict(cache_dir=out, datalist_path=dl, test_mode=test_mode)
        port, jx = ImagePrompt(**kw), JImagePrompt(**kw)
        assert len(port) == len(jx) == 3
        for i in range(3):
            a, b = port[i], jx[i]
            assert a['name'] == b['name'] == PROMPTS[i]
            pa, pb = a['prompt_embed_kwargs'], b['prompt_embed_kwargs']
            assert pa.keys() == pb.keys() == {'encoder_hidden_states',
                                             'pooled_projections'}
            for k in pa:
                np.testing.assert_array_equal(pa[k], np.asarray(pb[k]))
                np.testing.assert_array_equal(pa[k],
                                              direct[k][i].float().numpy())
            key = 'noise' if test_mode else 'latents'
            assert a[key].shape == (8, 6, 16)
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))
    assert pa['encoder_hidden_states'].shape == (8, 48)
    assert pa['pooled_projections'].shape == (32,)


def _write_images(root, n_per_class=(2, 1), size=(20, 28)):
    from PIL import Image
    rng = np.random.default_rng(0)
    for ci, n in enumerate(n_per_class):
        os.makedirs(root / f'class{ci}')
        for j in range(n):
            Image.fromarray(rng.integers(0, 256, (*size, 3), np.uint8)).save(
                root / f'class{ci}' / f'{j}.png')


def test_cache_imagenet_latents_read_back_channel_first(tmp_path):
    from arcflow_tpu_torch.data import ImageNet, collate
    from arcflow_tpu_torch.tools import cache_imagenet_data_sdvae as tool
    images = tmp_path / 'images'
    _write_images(images)
    from arcflow_tpu_torch import models
    tiny = functools.partial(models.PretrainedVAEEncoder,
                             block_out_channels=(32, 32), layers_per_block=1)
    with mock.patch.object(models, 'PretrainedVAEEncoder', tiny):
        tool.main(['--image-dir', str(images), '--out',
                   str(tmp_path / 'lat'), '--image-size', '16', '--batch',
                   '2', '--device', 'cpu'])
        vae = tool.build_encoder('cpu')
    ds = ImageNet(image_dir=str(images), image_size=16)
    want = vae.encode(torch.from_numpy(
        collate([ds[i] for i in range(3)])['images']) * 2 - 1)
    got = ImageNet(latents_dir=str(tmp_path / 'lat'))
    assert len(got) == 3
    for i in range(3):
        item = got[i]
        assert item['label'] == ds[i]['label'] == [0, 0, 1][i]
        assert item['latents'].shape == (8, 8, 4)
        np.testing.assert_allclose(item['latents'], want[i].detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match='--vae-dir'):
        tool.main(['--image-dir', str(images), '--out', str(tmp_path / 'x'),
                   '--vae-dir', str(tmp_path), '--device', 'cpu'])


def test_jax_imagenet_cacher_writes_channel_last_which_reads_transposed(
        tmp_path):
    """JAX's ``tools/cache_imagenet_data_sdvae.py:58-59`` saves the
    channel-last latents of its encoder; ``ImageNet`` (JAX's and the
    port's) takes ``x`` as (C, H, W) and moves axis 0 last, so JAX's
    records read back transposed. The port's cacher writes (C, H, W)."""
    import arcflow_tpu.models as j_models
    import arcflow_tpu.utils as j_utils
    from arcflow_tpu.data import ImageNet as JImageNet
    images = tmp_path / 'images'
    _write_images(images, n_per_class=(1,), size=(16, 16))
    tiny = functools.partial(j_models.PretrainedVAEEncoder,
                             block_out_channels=(32, 32), layers_per_block=1,
                             dtype='float32')
    with mock.patch.object(j_models, 'PretrainedVAEEncoder', tiny), \
            mock.patch.object(j_utils, 'setup_jax', lambda: None):
        run_script('tools/cache_imagenet_data_sdvae.py', '--image-dir',
                   str(images), '--out', str(tmp_path / 'jax'),
                   '--image-size', '16')
    raw = np.load(tmp_path / 'jax' / '00000000.npz')['x']
    assert raw.shape == (8, 8, 4)                  # (H, W, C) written
    item = JImageNet(latents_dir=str(tmp_path / 'jax'))[0]
    assert item['latents'].shape == (8, 4, 8)      # read as (W, C, H)
    np.testing.assert_array_equal(item['latents'], np.moveaxis(raw, 0, -1))


def test_validate_toy_e2e_runs_both_stages(tmp_path, capsys):
    """Both stages at the configs' widths, cut to 300 + 100 iterations
    (they read 0.504 here; 20 + 10 read 0.285), and 4096 samples scored as
    JAX's tool scores them (``CheckerboardData().log_prob_support``). The
    bar, 0.4, lies between that and noise: a standard normal reads 0.2335
    inside the board's white squares, and an untrained or broken stage
    reads near it or below."""
    from arcflow_tpu.data.checkerboard import \
        CheckerboardData as JCheckerboardData
    from arcflow_tpu_torch.tools.validate_toy_e2e import validate
    share, samples = validate(str(tmp_path), flow_iters=300,
                              distill_iters=100, num_samples=4096,
                              device='cpu', repo=REPO)
    assert samples.shape == (4096, 2) and samples.dtype == np.float32
    assert share == float(JCheckerboardData().log_prob_support(
        samples).mean())
    noise = np.random.default_rng(0).standard_normal((4096, 2))
    assert JCheckerboardData().log_prob_support(noise).mean() < 0.3
    assert share > 0.4, share
    assert os.path.isdir(tmp_path / 'flow' / 'checkpoints')
    assert os.path.isdir(tmp_path / 'distill' / 'checkpoints')
    out = capsys.readouterr().out
    assert 'flow pretraining done' in out and 'distillation done' in out
