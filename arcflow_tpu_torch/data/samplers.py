"""Resolution-bucketized batch sampling.

Counterpart of ``arcflow_tpu/data/samplers.py`` (``BucketizedBatchSampler``,
``build_bucketized_loader``): every global batch draws from one resolution
bucket (mixed resolutions cannot stack), each bucket is padded to a whole
number of global batches by wrap-around, batches are shuffled across
buckets and dealt round-robin to the replicas. An epoch's schedule is a
function of (seed, epoch) alone, drawn with numpy as in JAX, so the port
draws the JAX batches for a seed and a resumed run skips to its iteration
by arithmetic.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class BucketizedBatchSampler:
    def __init__(self, bucket_ids: Sequence[int], batch_size: int,
                 num_replicas: int = 1, rank: int = 0, seed: int = 0,
                 shuffle: bool = True):
        self.bucket_ids = np.asarray(bucket_ids, np.int64)
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.shuffle = shuffle
        self.buckets = {int(b): np.nonzero(self.bucket_ids == b)[0]
                        for b in np.unique(self.bucket_ids)}

    def epoch_batches(self, epoch: int) -> List[np.ndarray]:
        """Every global batch of one epoch: each from one bucket, padded to
        a full batch by wrap-around, shuffled across buckets."""
        rng = np.random.default_rng([self.seed, epoch])
        global_bs = self.batch_size * self.num_replicas
        batches = []
        for _, idx in sorted(self.buckets.items()):
            idx = rng.permutation(idx) if self.shuffle else idx.copy()
            pad = (-len(idx)) % global_bs
            if pad:
                idx = np.concatenate([idx, idx[:pad] if len(idx) >= pad
                                      else np.resize(idx, pad)])
            batches.extend(np.split(idx, len(idx) // global_bs))
        if self.shuffle:
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches

    def __len__(self):
        return len(self.epoch_batches(0))

    def iter_batches(self, start_iter: int = 0) -> Iterator[np.ndarray]:
        """This replica's endless batch stream from iteration
        ``start_iter``."""
        per_epoch = len(self)
        it = start_iter
        while True:
            epoch, offset = divmod(it, per_epoch)
            batches = self.epoch_batches(epoch)
            while offset < per_epoch:
                g = batches[offset]
                yield g[self.rank * self.batch_size:
                        (self.rank + 1) * self.batch_size]
                offset += 1
                it += 1


def build_bucketized_loader(dataset, batch_size: int, num_replicas: int = 1,
                            rank: int = 0, seed: int = 0, start_iter: int = 0,
                            shuffle: bool = True, prefetch_depth: int = 2):
    """Collated batches from ``dataset.bucket_ids`` (one bucket when the
    dataset has none), made on a background thread."""
    bucket_ids = getattr(dataset, 'bucket_ids', None)
    if bucket_ids is None:
        bucket_ids = np.zeros(len(dataset), np.int64)
    sampler = BucketizedBatchSampler(bucket_ids, batch_size, num_replicas,
                                     rank, seed, shuffle)
    from .prefetch import batched_index_loader
    return batched_index_loader(dataset, sampler.iter_batches(start_iter),
                                prefetch_depth=prefetch_depth)
