"""Host-side batch iterators feeding the device.

Counterpart of ``arcflow_tpu/data/builder.py``: every batch's randomness
derives from ``np.random.default_rng([seed, iteration, rank])``, so a run
resumed at iteration N draws the batches a straight run draws there,
without replaying N batches, and the port's batches are bitwise the JAX
package's for the same seed, ``start_iter`` and rank. Batches are numpy on
the host; the runner moves them to the model's device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..registry import DATASETS


def build_dataset(cfg):
    return DATASETS.build(cfg)


def collate(samples) -> dict:
    """A list of sample dicts -> one dict of stacked arrays (nested dicts
    collate recursively; other values stay lists)."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], dict):
            out[k] = collate(vals)
        elif isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


def build_dataloader(dataset, samples_per_gpu: int, seed: int = 0,
                     start_iter: int = 0, shuffle: bool = True,
                     num_replicas: int = 1, rank: int = 0) -> Iterator[dict]:
    """Infinite iterator of dict batches (numpy, host memory) from
    iteration ``start_iter`` on. A dataset with ``batch(rng, n)`` (the
    synthetic ones) makes each batch itself; a map-style dataset is sampled
    by index, at random or, without ``shuffle``, in order across the
    ``num_replicas`` ranks."""
    if isinstance(dataset, dict):
        dataset = build_dataset(dataset)

    def gen():
        it = start_iter
        n = len(dataset)
        while True:
            rng = np.random.default_rng([seed, it, rank])
            if hasattr(dataset, 'batch'):
                yield dataset.batch(rng, samples_per_gpu)
            else:
                if shuffle:
                    idx = rng.integers(0, n, size=samples_per_gpu)
                else:
                    base = (it * num_replicas + rank) * samples_per_gpu
                    idx = (base + np.arange(samples_per_gpu)) % n
                yield collate([dataset[int(i)] for i in idx])
            it += 1

    return gen()
