"""Port parity: arcflow_tpu_torch.data's loader against the JAX package's,
and the Prefetcher's lifecycle.

``build_dataloader`` must give bitwise the JAX batches for the same seed,
start iteration and rank (both draw from ``np.random.default_rng([seed,
it, rank])``), so a resumed run sees the batches a straight run sees. The
``Prefetcher`` contract is that of ``tests/test_prefetch_close.py``.
"""

import itertools
import threading
import time

import numpy as np
import pytest

from arcflow_tpu.data import CheckerboardData as JCheckerboard
from arcflow_tpu.data import build_dataloader as j_build_dataloader
from arcflow_tpu.data import collate as j_collate
from arcflow_tpu_torch.data import (CheckerboardData, Prefetcher,
                                    build_dataloader, build_dataset, collate)


class Indexed:
    """A map-style dataset of nested samples."""

    def __len__(self):
        return 37

    def __getitem__(self, i):
        return dict(x=np.full((3,), i, np.float32),
                    meta=dict(idx=np.int64(i), w=np.float32(i) / 2),
                    name=f's{i}')


def _take(loader, n):
    return list(itertools.islice(loader, n))


def _assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize('seed, start_iter, rank', [
    (0, 0, 0), (0, 5, 0), (3, 0, 1), (7, 1234, 3)])
def test_checkerboard_batches_bitwise_jax(seed, start_iter, rank):
    kw = dict(seed=seed, start_iter=start_iter, num_replicas=4, rank=rank)
    got = _take(build_dataloader(
        CheckerboardData(n_rc=4, rotation=15.0), 64, **kw), 4)
    want = _take(j_build_dataloader(
        JCheckerboard(n_rc=4, rotation=15.0), 64, **kw), 4)
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_resume_sees_the_straight_batches():
    straight = _take(build_dataloader(CheckerboardData(), 16, seed=2), 6)
    resumed = _take(build_dataloader(CheckerboardData(), 16, seed=2,
                                     start_iter=4), 2)
    for a, b in zip(straight[4:], resumed):
        np.testing.assert_array_equal(a['x'], b['x'])
    assert not np.array_equal(straight[0]['x'], straight[1]['x'])


@pytest.mark.parametrize('shuffle', [True, False])
@pytest.mark.parametrize('rank', [0, 2])
def test_map_style_batches_bitwise_jax(shuffle, rank):
    kw = dict(seed=5, start_iter=3, shuffle=shuffle, num_replicas=3,
              rank=rank)
    got = _take(build_dataloader(Indexed(), 8, **kw), 3)
    want = _take(j_build_dataloader(Indexed(), 8, **kw), 3)
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_collate_and_dataset_config_match_jax():
    samples = [Indexed()[i] for i in (4, 9)]
    _assert_same(collate(samples), j_collate(samples))
    ds = build_dataset(dict(type='CheckerboardData', n_rc=2, scale=0.5))
    assert isinstance(ds, CheckerboardData) and ds.n_rc == 2
    got = next(build_dataloader(dict(type='CheckerboardData', n_rc=2), 8))
    want = next(j_build_dataloader(dict(type='CheckerboardData', n_rc=2), 8))
    _assert_same(got, want)


def test_prefetcher_close_unblocks_full_queue_producer():
    produced = []

    def gen():
        for i in itertools.count():
            produced.append(i)
            yield i

    p = Prefetcher(gen(), depth=2)
    assert next(p) == 0
    time.sleep(0.3)                   # the producer fills the queue, blocks
    n_before = threading.active_count()
    p.close()
    assert not p._thread.is_alive(), 'the worker must end on close()'
    assert threading.active_count() <= n_before
    p.close()                         # idempotent
    with pytest.raises(StopIteration):
        next(p)


def test_prefetcher_drains_a_finite_iterator_and_raises_its_errors():
    p = Prefetcher(iter([1, 2, 3]), depth=2)
    assert list(p) == [1, 2, 3]
    p.close()

    def failing():
        yield 1
        raise ValueError('bad batch')

    p = Prefetcher(failing())
    assert next(p) == 1
    with pytest.raises(ValueError, match='bad batch'):
        next(p)
    p.close()


def test_prefetcher_keeps_the_loader_order():
    want = _take(build_dataloader(CheckerboardData(), 8, seed=1), 5)
    p = Prefetcher(build_dataloader(CheckerboardData(), 8, seed=1), depth=3)
    got = _take(p, 5)
    p.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a['x'], b['x'])


def test_prefetcher_stages_batches_on_the_device():
    """With ``device`` the worker hands out the loader's batches as tensors
    on that device (the runner's ``to_device``), values unchanged; strings
    stay as they are."""
    import torch
    want = _take(build_dataloader(CheckerboardData(), 8, seed=1), 3)
    prompts = ({'x': b['x'], 'prompt': np.array(['a'] * 8)} for b in
               build_dataloader(CheckerboardData(), 8, seed=1))
    p = Prefetcher(prompts, depth=2, device=torch.device('cpu'))
    got = _take(p, 3)
    p.close()
    for a, b in zip(got, want):
        assert isinstance(a['x'], torch.Tensor) and a['x'].device.type == 'cpu'
        np.testing.assert_array_equal(a['x'].numpy(), b['x'])
        assert a['prompt'].dtype.kind == 'U'
