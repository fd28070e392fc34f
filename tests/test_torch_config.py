"""Port parity: arcflow_tpu_torch.config and .registry against the JAX
package's, and the port's independence from JAX.

Every config file of the repo loads through the port's ``Config`` to the
dict the JAX ``Config`` gives; ``_base_``, ``_delete_``, ``merge_from_dict``
and ``dump`` agree on small files; the registries build what the configs
name and refuse what they do not know. Exact equality throughout: both
sides are the same pure-Python logic.
"""

import ast
import copy
import glob
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from arcflow_tpu.config import Config as JConfig
from arcflow_tpu.config import _parse_value as j_parse_value
from arcflow_tpu_torch import MODELS, MODULES, Config
from arcflow_tpu_torch.config import _parse_value
from arcflow_tpu_torch.registry import Registry

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(os.path.relpath(p, REPO) for p in
                 glob.glob(str(REPO / 'configs' / '**' / '*.py'),
                           recursive=True))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'arcflow_tpu')


def _write(tmp_path, name, content):
    p = tmp_path / name
    p.write_text(textwrap.dedent(content))
    return str(p)


@pytest.mark.parametrize('path', CONFIGS)
def test_every_config_loads_as_in_jax(path):
    got, want = Config.fromfile(str(REPO / path)), \
        JConfig.fromfile(str(REPO / path))
    assert got.to_dict() == want.to_dict()
    assert got.text == want.text


def test_base_delete_merge_and_dump_match_jax(tmp_path):
    _write(tmp_path, 'base.py', '''
        model = dict(type='Foo', depth=3, head=dict(type='Bar', k=16))
        opt = dict(type='AdamW', lr=1e-4, wd=0.01)
        data = dict(batch_size=4)
    ''')
    f = _write(tmp_path, 'child.py', '''
        _base_ = ['base.py']
        model = dict(depth=7, head=dict(k=32))
        opt = dict(_delete_=True, type='SGD', lr=0.1)
        extra = True
    ''')
    got, want = Config.fromfile(f), JConfig.fromfile(f)
    assert got.to_dict() == want.to_dict()
    assert got.model.head.type == 'Bar' and 'wd' not in got.opt
    options = {'model.depth': '9', 'opt.lr': '3e-5', 'model.act': 'silu',
               'flag': 'true', 'none': 'null', 'shape': '(64,64)',
               'model.head': dict(_delete_=True, type='Baz')}
    # merging pops _delete_ from the option's dict: each side its own copy
    got.merge_from_dict(copy.deepcopy(options))
    want.merge_from_dict(copy.deepcopy(options))
    assert got.to_dict() == want.to_dict()
    assert got.model.depth == 9 and got.flag is True and got.none is None
    assert got.shape == (64, 64) and got.model.head == {'type': 'Baz'}
    for v in ('1e-3', 'True', 'None', 'abc', '[1, 2]', 3):
        assert _parse_value(v) == j_parse_value(v)
    a, b = str(tmp_path / 'a' / 'dump.py'), str(tmp_path / 'b' / 'dump.py')
    got.dump(a)
    want.dump(b)
    assert open(a).read() == open(b).read()
    # the dump is the config's dict as a Python literal
    assert ast.literal_eval(open(a).read()) == got.to_dict()


def test_base_errors_match_jax(tmp_path):
    _write(tmp_path, 'b1.py', 'x = 1\n')
    _write(tmp_path, 'b2.py', 'x = 2\n')
    dup = _write(tmp_path, 'dup.py', "_base_ = ['b1.py', 'b2.py']\n")
    with pytest.raises(KeyError, match='duplicate'):
        Config.fromfile(dup)
    _write(tmp_path, 'scalar.py', 'model = 3\n')
    over = _write(tmp_path, 'over.py', '''
        _base_ = 'scalar.py'
        model = dict(depth=1)
    ''')
    with pytest.raises(TypeError, match='_delete_'):
        Config.fromfile(over)
    with pytest.raises(FileNotFoundError):
        Config.fromfile(str(tmp_path / 'missing.py'))


def test_registry_builds_and_refuses():
    reg = Registry('things')

    @reg.register_module()
    class Thing:
        def __init__(self, a=1, b=2):
            self.a, self.b = a, b

    t = reg.build(dict(type='Thing', a=5), default_args=dict(b=7, a=0))
    assert (t.a, t.b) == (5, 7)
    assert reg.build(t) is t and reg.build(None) is None
    with pytest.raises(KeyError, match='already registered'):
        reg.register_module(module=Thing)
    with pytest.raises(KeyError, match='Nope is not registered'):
        reg.build(dict(type='Nope'))
    with pytest.raises(KeyError, match='no "type"'):
        reg.build(dict(a=1))
    # the port's registries know the names the configs use
    for name in ('LatentDiffusionTextImage', 'Diffusion2D', 'Distillation2D'):
        assert name in MODELS
    for name in ('GaussianFlow', 'GMFlow', 'ArcFlowImitation',
                 'ArcFlowImitationDataFree', 'ArcFluxTransformer2DModel',
                 'FluxTransformer2DModel', 'ArcQwenImageTransformer2DModel',
                 'ToyMLPDenoiser', 'ToyArcFlowDenoiser', 'ToyGMFlowDenoiser',
                 'SpectrumMLP', 'DiffusionMSELoss', 'GMFlowNLLLoss',
                 'ContinuousTimeStepSampler'):
        assert name in MODULES, name
    flow = MODULES.build(dict(
        type='GaussianFlow', num_timesteps=10,
        denoising=dict(type='ToyMLPDenoiser', hidden=(8,)),
        flow_loss=dict(type='DiffusionMSELoss')), default_args=dict(
            device='cpu'))
    assert flow.timestep_sampler.num_timesteps == 10
    assert flow.denoising.LoRADense_0.weight.device.type == 'cpu'
    with pytest.raises(KeyError, match='NoSuchDenoiser'):
        MODULES.build(dict(type='GaussianFlow',
                           denoising=dict(type='NoSuchDenoiser')))


@pytest.mark.parametrize('cfg, match', [
    (dict(type='GaussianFlow', denoising_mean_mode='X0'), 'only u-pred'),
    (dict(type='ArcFlowImitation', policy_type='GMFlow'), 'only ArcFlow'),
    (dict(type='ToyArcFlowDenoiser', moe_experts=4), 'ROADMAP'),
    (dict(type='ArcFluxTransformer2DModel', patch_size=1, num_layers=0,
          num_single_layers=0, device='meta'), 'patch_size must be 2'),
    (dict(type='FluxTransformer2DModel', pretrained='x', num_layers=0,
          num_single_layers=0, device='meta'), 'pretrained must be None'),
])
def test_refusals_stay_explicit(cfg, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        MODULES.build(cfg)


def test_flux_config_builds_through_the_registry():
    """configs/flux/arcflux_2nfe_k16.py through the port's MODELS, cut to
    2 + 2 blocks of 2 x 16 on the CPU: the student is an ArcFlow data-free
    distillation with a LoRA adapter, the tied teacher borrows its trunk."""
    cfg = Config.fromfile(str(REPO / 'configs/flux/arcflux_2nfe_k16.py'))
    net = {'num_layers': 2, 'num_single_layers': 2, 'attention_head_dim': 16,
           'num_attention_heads': 2, 'joint_attention_dim': 32,
           'pooled_projection_dim': 16, 'axes_dims_rope': (4, 6, 6),
           'lora_rank': 4}
    opts = {f'model.diffusion.denoising.{k}': v for k, v in net.items()}
    opts.update({f'model.teacher.denoising.{k}': v for k, v in net.items()
                 if k != 'lora_rank'})
    opts.update({'model.text_embed_dim': 32, 'model.pooled_dim': 16})
    cfg.merge_from_dict(opts)
    model = MODELS.build(cfg.model, default_args=dict(
        train_cfg=cfg.train_cfg, test_cfg=cfg.test_cfg, device='cpu',
        dtype=torch.float32))
    trainable, frozen = model.init_params()
    assert type(model.diffusion).__name__ == 'ArcFlowImitationDataFree'
    assert type(model.teacher.denoising).__name__ == 'FluxTransformer2DModel'
    assert all('lora' in n or n.startswith(('proj_out', 'norm_out'))
               for n in trainable['diffusion'])
    shared = model.teacher.denoising.joint_blocks[0].attn.img_q.weight
    assert shared is frozen['base']['joint_blocks.0.attn.img_q.weight']


def _imports(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_smoke_import_no_jax():
    """No module of the port and nothing in chip_smoke.py imports JAX, its
    libraries or the JAX package (statically, every import statement); and
    importing every port module in a fresh process loads none of them."""
    files = sorted(glob.glob(str(REPO / 'arcflow_tpu_torch' / '**' / '*.py'),
                             recursive=True)) + [str(REPO / 'chip_smoke.py')]
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad
    mods = sorted({os.path.relpath(f, REPO)[:-3].replace(os.sep, '.')
                   .removesuffix('.__init__') for f in files[:-1]})
    code = ('import importlib, sys\n'
            f'for m in {mods!r}:\n'
            '    importlib.import_module(m)\n'
            'bad = sorted(m for m in sys.modules\n'
            f'             if m.split(".")[0] in {FORBIDDEN!r})\n'
            'assert not bad, bad\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
