"""Port parity for the native record loader (``arcflow_tpu_torch/data/
_fastloader``): the port's own build of the C++ against the JAX package's
build (``arcflow_tpu/data/_fastloader``) and against python-zstd on the
same records, following ``tests/test_fastloader.py``; and
``ImagePrompt.getitems`` through it against item-by-item reads.

Every comparison is exact (bytes, or arrays bit for bit). The records are
written both by a streaming compressor (no content size in the frame: the
loader's streaming path) and in one shot (content size known: its bounded
path). g++, ``zstd.h`` and libzstd are on this machine; without them the
port's ``get_fastloader`` returns None and says why, which the last test
forces.
"""

import importlib
import pickle

import numpy as np
import pytest

from arcflow_tpu_torch.data import ImagePrompt
from arcflow_tpu_torch.data import _fastloader as fastloader
from arcflow_tpu_torch.ops._build import BUILD_DIR


@pytest.fixture(scope='module')
def fast():
    mod = fastloader.get_fastloader()
    assert mod is not None, fastloader.unavailable_reason()
    return mod


@pytest.fixture(scope='module')
def jax_fast():
    from arcflow_tpu.data._fastloader import get_fastloader
    mod = get_fastloader()
    assert mod is not None
    return mod


def write_records(tmp_path, n=12, size=20000, one_shot=False):
    """(paths, payloads): pickled dicts of seeded arrays, each in a zstd
    frame of its own."""
    import zstandard as zstd
    paths, blobs = [], []
    for i in range(n):
        payload = pickle.dumps(dict(
            idx=i, arr=np.random.default_rng(i).standard_normal(
                size + 17 * i).astype(np.float32)))
        blobs.append(payload)
        p = str(tmp_path / f'r{i:04d}.zst')
        with open(p, 'wb') as f:
            if one_shot:
                f.write(zstd.ZstdCompressor().compress(payload))
            else:
                with zstd.ZstdCompressor().stream_writer(f) as z:
                    z.write(payload)
        paths.append(p)
    return paths, blobs


def test_built_into_the_ports_build_directory(fast):
    assert fast.__file__ == str(fastloader.library_path())
    assert fastloader.library_path().parent == BUILD_DIR
    assert fastloader.unavailable_reason() is None


@pytest.mark.parametrize('one_shot', [False, True])
def test_port_decodes_as_jax_and_python_zstd(fast, jax_fast, tmp_path,
                                             one_shot):
    paths, blobs = write_records(tmp_path, one_shot=one_shot)
    got = fast.load_batch(paths, num_threads=4)
    assert got == blobs
    assert got == jax_fast.load_batch(paths, num_threads=4)
    assert fast.load_batch(paths, num_threads=0, decompress=True) == blobs


def test_raw_bytes_without_decompression(fast, jax_fast, tmp_path):
    paths, _ = write_records(tmp_path, n=3)
    raw = fast.load_batch(paths, decompress=False)
    assert raw == [open(p, 'rb').read() for p in paths]
    assert raw == jax_fast.load_batch(paths, decompress=False)


def test_missing_file_raises(fast, tmp_path):
    paths, _ = write_records(tmp_path, n=2)
    with pytest.raises(IOError, match='nope.zst'):
        fast.load_batch([paths[0], str(tmp_path / 'nope.zst')])


@pytest.mark.parametrize('one_shot', [False, True])
def test_truncated_record_raises(fast, tmp_path, one_shot):
    """A truncated frame raises, never returning partial bytes."""
    paths, _ = write_records(tmp_path, n=1, size=200000, one_shot=one_shot)
    data = open(paths[0], 'rb').read()
    bad = str(tmp_path / 'truncated.zst')
    with open(bad, 'wb') as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(IOError, match='truncated.zst'):
        fast.load_batch([bad])


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_item(a[k], b[k])
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize('test_mode', [False, True])
def test_getitems_through_the_loader_equals_item_reads(fast, tmp_path,
                                                       monkeypatch,
                                                       test_mode):
    """``getitems`` decodes through the loader (a spy counts its batches)
    and gives what ``__getitem__`` gives, record by record, with repeats
    and the legacy keys of ``tests/test_torch_image_prompts.py``'s
    cache."""
    write_cache = importlib.import_module(
        'test_torch_image_prompts').write_cache
    cache, dl = write_cache(tmp_path)
    ds = ImagePrompt(cache_dir=cache, datalist_path=dl, pad_seq_len=10,
                     repeat=2, test_mode=test_mode)
    calls = []
    real = fastloader.get_fastloader

    class Spy:
        def load_batch(self, paths, **kw):
            calls.append(len(paths))
            return real().load_batch(paths, **kw)
    monkeypatch.setattr(fastloader, 'get_fastloader', lambda: Spy())
    idx = [0, 3, 5, 9, 14, 1]
    items = ds.getitems(idx)
    assert calls == [len(idx)]
    for i, item in zip(idx, items):
        _same_item(item, ds[i])


def test_without_the_toolchain_it_is_none_and_says_why(tmp_path,
                                                       monkeypatch):
    """No g++ (as on a machine without it): None, the reason recorded,
    and ``getitems`` reads item by item."""
    monkeypatch.setattr(fastloader, '_TRIED', False)
    monkeypatch.setattr(fastloader, '_MODULE', None)
    monkeypatch.setattr(fastloader, '_REASON', None)
    monkeypatch.setattr(fastloader, 'library_path',
                        lambda: tmp_path / 'absent.so')
    monkeypatch.setattr(fastloader.shutil, 'which', lambda name: None)
    assert fastloader.get_fastloader() is None
    assert 'g++ not found' in fastloader.unavailable_reason()
    write_cache = importlib.import_module(
        'test_torch_image_prompts').write_cache
    cache, dl = write_cache(tmp_path)
    ds = ImagePrompt(cache_dir=cache, datalist_path=dl)
    for i, item in zip([2, 4], ds.getitems([2, 4])):
        _same_item(item, ds[i])
