"""Port parity: ``utils/io_utils`` against the JAX package's, and the
remote URIs it opens in the loaders (``load_adapter_state``,
``load_safetensors_state``, ``ArcFluxPipeline.from_pretrained``).

Schemes and backends must agree with JAX's for every URI; the PNG files of
``save_image`` / ``save_image_grid`` must be byte-identical to JAX's for the
same arrays. Remote storage is faked on ``tmp_path`` by backend instances
(one with only the byte interface, as S3 and HTTP have; one with only a
local cache, as the hub has), registered for the test and taken out again
with ``_BACKENDS.pop`` in both packages. Remote loads must equal the local
loads bit for bit, and JAX's ``load_safetensors_state`` on the same remote
sharded index.
"""

import json
import os
import shutil
import sys
import time
import types
from unittest import mock

import numpy as np
import pytest
import torch

from arcflow_tpu.pipelines.convert import \
    load_safetensors_state as j_load_safetensors_state
from arcflow_tpu.utils import io_utils as j_io
from arcflow_tpu_torch.models import ArcFluxTransformer2DModel
from arcflow_tpu_torch.pipelines import (ArcFluxPipeline, load_adapter_state,
                                         save_adapter_state)
from arcflow_tpu_torch.pipelines.convert import (load_safetensors_state,
                                                 torch_to_diffusers)
from arcflow_tpu_torch.utils import io_utils

torch.set_num_threads(1)

URIS = ['s3://bucket/a/b.safetensors', 'huggingface://org/repo/x.json',
        'http://host/f', 'https://host/f', '/abs/path', 'rel/path',
        'tmp:job', 'file.safetensors']
FLUX = dict(in_channels=16, num_layers=2, num_single_layers=2,
            attention_head_dim=16, num_attention_heads=2,
            joint_attention_dim=24, pooled_projection_dim=8,
            axes_dims_rope=(4, 6, 6), num_gaussians=4, lora_rank=2,
            checkpointing=False)


class BytesBackend:
    """Remote storage with no local cache, only get / put (bytes),
    get_file / put_file (streamed) / exists / join_path (as S3 and HTTP
    have), kept under ``root``. A ``put`` body over ``limit`` bytes is
    refused, as S3 refuses a single PUT over 5 GB."""

    def __init__(self, root, scheme='s3://', limit=None):
        self.root, self.scheme, self.limit = str(root), scheme, limit
        self.gets, self.puts = [], []

    def _local(self, uri):
        return os.path.join(self.root, uri[len(self.scheme):])

    def get(self, uri):
        self.gets.append(uri)
        with open(self._local(uri), 'rb') as f:
            return f.read()

    def put(self, data, uri):
        if self.limit is not None and len(data) > self.limit:
            raise ValueError(f'EntityTooLarge: {len(data)} bytes')
        self.puts.append(uri)
        p = self._local(uri)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, 'wb') as f:
            f.write(data)

    def get_file(self, uri, local_path):
        self.gets.append(uri)
        shutil.copyfile(self._local(uri), local_path)

    def put_file(self, local_path, uri):
        p = self._local(uri)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        shutil.copyfile(local_path, p)

    def exists(self, uri):
        return os.path.exists(self._local(uri))

    def join_path(self, *parts):
        return '/'.join(p.rstrip('/') for p in parts)


class CacheBackend:
    """A hub-like backend: files resolve to a local cache (``local_path``)
    and have no byte interface of their own."""

    def __init__(self, root):
        self.root = str(root)

    def local_path(self, uri):
        assert uri.startswith('huggingface://org/repo/'), uri
        path = os.path.join(self.root, uri[len('huggingface://org/repo/'):])
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return path

    def exists(self, uri):
        try:
            self.local_path(uri)
            return True
        except FileNotFoundError:
            return False

    def get(self, uri):
        with open(self.local_path(uri), 'rb') as f:
            return f.read()

    def join_path(self, *parts):
        return '/'.join(p.rstrip('/') for p in parts)


@pytest.fixture
def backends():
    """Register fakes in both packages for one test, then take them out."""
    registered = []

    def register(scheme, backend, jax_too=False):
        io_utils.register_backend(scheme, backend)
        registered.append((io_utils, scheme))
        if jax_too:
            j_io.register_backend(scheme, backend)
            registered.append((j_io, scheme))
    yield register
    for module, scheme in registered:
        module._BACKENDS.pop(scheme, None)


@pytest.mark.parametrize('uri', URIS)
def test_uri_scheme_and_backend_class_match_jax(uri):
    assert io_utils.uri_scheme(uri) == j_io.uri_scheme(uri)
    scheme = io_utils.uri_scheme(uri)
    want = {'s3': 'S3Backend', 'http': 'HTTPBackend',
            'huggingface': 'HuggingFaceBackend', 'local': 'LocalBackend'}
    if scheme == 's3':
        # neither package has boto3 here: both refuse by name
        with pytest.raises(RuntimeError, match='boto3'):
            io_utils.get_file_backend(uri)
        with pytest.raises(RuntimeError, match='boto3'):
            j_io.get_file_backend(uri)
        assert scheme not in io_utils._BACKENDS
        return
    got = io_utils.get_file_backend(uri)
    assert type(got).__name__ == want[scheme] == \
        type(j_io.get_file_backend(uri)).__name__
    assert io_utils.get_file_backend(uri) is got      # one per scheme
    parts = ('s3://b/p/', 'dir', 'f.txt')
    assert got.join_path(*parts) == \
        j_io.get_file_backend(uri).join_path(*parts)


def test_local_backend_round_trip(tmp_path):
    be = io_utils.get_file_backend(str(tmp_path))
    path = str(tmp_path / 'sub' / 'f.bin')
    assert not be.exists(path)
    be.put(b'abc', path)
    assert be.exists(path) and be.get(path) == b'abc'
    with io_utils.local_file(path) as local:
        assert local == path


def test_hub_backend_reads_the_local_cache_only(monkeypatch):
    """The port's hub backend asks huggingface_hub for cached files only;
    JAX's may download (ROADMAP queue C)."""
    calls = []

    def fake_download(**kwargs):
        calls.append(kwargs)
        raise FileNotFoundError('not cached')
    monkeypatch.setitem(sys.modules, 'huggingface_hub', types.SimpleNamespace(
        hf_hub_download=fake_download))
    be = io_utils.HuggingFaceBackend()
    assert be.parse('huggingface://org/repo/sub/f.json') == \
        ('org/repo', 'sub/f.json') == \
        j_io.HuggingFaceBackend.parse('huggingface://org/repo/sub/f.json')
    assert not be.exists('huggingface://org/repo/f.json')
    assert calls == [dict(repo_id='org/repo', filename='f.json',
                          local_files_only=True)]
    calls.clear()
    assert not j_io.HuggingFaceBackend().exists('huggingface://org/repo/f.json')
    assert calls == [dict(repo_id='org/repo', filename='f.json')]


def test_retry_calls_again_then_raises(monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, 'sleep', sleeps.append)
    for retry in (io_utils.retry, j_io.retry):
        calls = []

        @retry(tries=3, delay=2.0, backoff=2.0, exceptions=(OSError,))
        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError('transient')
            return 'ok'
        assert flaky() == 'ok' and len(calls) == 3

        @retry(tries=2, delay=1.0, exceptions=(OSError,))
        def broken():
            calls.append(1)
            raise OSError('down')
        with pytest.raises(OSError, match='down'):
            broken()

        @retry(tries=5, delay=1.0, exceptions=(OSError,))
        def wrong():
            raise ValueError('not retried')
        with pytest.raises(ValueError):
            wrong()
    assert sleeps == [2.0, 4.0, 1.0] * 2


@pytest.mark.parametrize('local_rank, want', [(None, True), ('0', True),
                                              ('3', False)])
def test_node_local_rank_zero(monkeypatch, local_rank, want):
    if local_rank is None:
        monkeypatch.delenv('LOCAL_RANK', raising=False)
    else:
        monkeypatch.setenv('LOCAL_RANK', local_rank)
    assert io_utils.is_node_local_rank_zero() is want is \
        j_io.is_node_local_rank_zero()


@pytest.mark.parametrize('n, ncols', [(1, None), (4, None), (5, None),
                                      (6, 4)])
def test_png_bytes_equal_jax(tmp_path, n, ncols):
    """Bytes equal: the same uint8 rounding and tiling, PIL's encoder."""
    rng = np.random.default_rng(n)
    imgs = rng.random((n, 12, 10, 3)).astype(np.float32)
    imgs[0, 0, 0] = [-0.5, 1.5, 0.5]          # clipped on both sides
    a, b = tmp_path / 'port.png', tmp_path / 'jax.png'
    io_utils.save_image_grid(imgs, str(a), ncols=ncols)
    j_io.save_image_grid(imgs, str(b), ncols=ncols)
    assert a.read_bytes() == b.read_bytes()
    # a tensor gives the same file
    io_utils.save_image_grid(torch.from_numpy(imgs), str(a), ncols=ncols)
    assert a.read_bytes() == b.read_bytes()
    io_utils.save_image(imgs[0], str(a))
    j_io.save_image(imgs[0], str(b))
    assert a.read_bytes() == b.read_bytes()
    u8 = (imgs[0] * 255).astype(np.uint8)
    io_utils.save_image(u8, str(a))
    np.testing.assert_array_equal(io_utils.load_image(str(a)), u8)
    np.testing.assert_array_equal(j_io.load_image(str(a)), u8)


def _flux_model(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ArcFluxTransformer2DModel(device='cpu', dtype=torch.float32,
                                          **FLUX)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn_like(p))
    return model


def _adapter(model):
    return {k: v for k, v in model.state_dict().items()
            if any(s in k for s in ('proj_out_', 'norm_out', 'lora'))}


def test_remote_adapter_matches_local(tmp_path, backends):
    model = _flux_model()
    root = tmp_path / 'bucket'
    path = root / 'runs' / 'adapter.safetensors'
    save_adapter_state(str(path), _adapter(model),
                       policy_config=dict(nfe=2, temperature=0.7))
    local, policy = load_adapter_state(str(path))
    s3 = BytesBackend(root)
    backends('s3', s3)
    backends('huggingface', CacheBackend(root / 'runs'))
    for uri in ('s3://runs/adapter.safetensors',
                'huggingface://org/repo/adapter.safetensors'):
        got, got_policy = load_adapter_state(uri)
        assert got_policy == policy == dict(nfe=2, temperature=0.7)
        assert got.keys() == local.keys()
        for k in local:
            assert torch.equal(got[k], local[k]), k
    assert s3.gets == ['s3://runs/adapter.safetensors']


@pytest.fixture
def sharded(tmp_path):
    """A 2-shard checkpoint with its index, as a hub folder holds it."""
    from safetensors.numpy import save_file
    d = tmp_path / 'hub'
    d.mkdir()
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.ones((4,), np.float32)
    save_file({'w.a': a}, str(d / 'm-00001.safetensors'))
    save_file({'w.b': b}, str(d / 'm-00002.safetensors'))
    with open(d / 'model.safetensors.index.json', 'w') as f:
        json.dump({'weight_map': {'w.a': 'm-00001.safetensors',
                                  'w.b': 'm-00002.safetensors'}}, f)
    return d, dict(a=a, b=b)


def test_remote_sharded_index_matches_jax(sharded, backends):
    d, want = sharded
    backends('huggingface', CacheBackend(d), jax_too=True)
    backends('s3', BytesBackend(d, scheme='s3://repo/'))
    for uri in ('huggingface://org/repo/model.safetensors.index.json',
                'huggingface://org/repo',            # a folder: probed
                's3://repo/model.safetensors.index.json', 's3://repo'):
        got = load_safetensors_state(uri)
        assert sorted(got) == ['w.a', 'w.b'], uri
        np.testing.assert_array_equal(got['w.a'].numpy(), want['a'])
        np.testing.assert_array_equal(got['w.b'].numpy(), want['b'])
    jax_got = j_load_safetensors_state(
        'huggingface://org/repo/model.safetensors.index.json')
    for k in jax_got:
        np.testing.assert_array_equal(
            load_safetensors_state(
                'huggingface://org/repo/model.safetensors.index.json')[k]
            .numpy(), jax_got[k])
    one = load_safetensors_state('huggingface://org/repo/m-00002.safetensors')
    np.testing.assert_array_equal(one['w.b'].numpy(), want['b'])
    with pytest.raises(FileNotFoundError, match='no safetensors'):
        load_safetensors_state('huggingface://org/repo/empty')


def test_remote_folder_on_a_byte_backend_loads_unlike_jax(sharded,
                                                          backends):
    """JAX's ``load_safetensors_state`` refuses a remote file on a backend
    without a local cache (``arcflow_tpu/pipelines/convert.py:219-220``:
    s3://, http://), though its ``load_adapter_state`` fetches such bytes;
    the port fetches them for both (ROADMAP queue C)."""
    d, want = sharded
    backends('s3', BytesBackend(d, scheme='s3://repo/'), jax_too=True)
    with pytest.raises(ValueError, match='cannot resolve local files'):
        j_load_safetensors_state('s3://repo/m-00002.safetensors')
    got = load_safetensors_state('s3://repo/m-00002.safetensors')
    np.testing.assert_array_equal(got['w.b'].numpy(), want['b'])


def test_from_pretrained_on_a_remote_folder(tmp_path, backends):
    model = _flux_model(seed=3)
    d = tmp_path / 'bucket' / 'flux'
    d.mkdir(parents=True)
    from safetensors.torch import save_file
    save_file({k: v.contiguous() for k, v in
               torch_to_diffusers(model.state_dict()).items()},
              str(d / 'diffusion_pytorch_model.safetensors'))
    with open(d / 'config.json', 'w') as f:
        json.dump(dict(FLUX, _class_name='ArcFluxTransformer2DModel'), f)
    save_adapter_state(str(d / 'adapter.safetensors'),
                       {k: v + 0.1 for k, v in _adapter(model).items()},
                       policy_config=dict(nfe=2, temperature=0.5))
    cpu = dict(device='cpu', dtype=torch.float32)
    local = ArcFluxPipeline.from_pretrained(str(d), **cpu)
    local.load_arcflow_adapter(str(d / 'adapter.safetensors'))
    backends('s3', BytesBackend(tmp_path / 'bucket'))
    remote = ArcFluxPipeline.from_pretrained('s3://flux', **cpu)
    assert type(remote.transformer) is ArcFluxTransformer2DModel
    policy = remote.load_arcflow_adapter('s3://flux/adapter.safetensors')
    assert policy['temperature'] == 0.5
    assert remote.diffusion.test_cfg['temperature'] == 0.5
    want, got = local.transformer.state_dict(), \
        remote.transformer.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # a remote pipeline folder is refused by name, as in JAX
    (d / 'model_index.json').write_text('{}')
    with pytest.raises(NotImplementedError, match='model_index'):
        ArcFluxPipeline.from_pretrained('s3://flux', **cpu)


def test_local_file_removes_its_download(tmp_path, backends):
    be = BytesBackend(tmp_path)
    be.put(b'payload', 's3://x/f.bin')
    backends('s3', be)
    with mock.patch('tempfile.tempdir', str(tmp_path / 'tmp')):
        os.makedirs(tmp_path / 'tmp')
        with io_utils.local_file('s3://x/f.bin', suffix='.bin') as local:
            assert open(local, 'rb').read() == b'payload'
            assert os.path.dirname(local) == str(tmp_path / 'tmp')
        assert os.listdir(tmp_path / 'tmp') == []
