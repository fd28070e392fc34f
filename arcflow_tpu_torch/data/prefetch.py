"""Background batch prefetching.

Counterpart of ``arcflow_tpu/data/prefetch.py:Prefetcher``: batches are
made on a worker thread while the device runs the previous step. The
worker puts with a timeout, so ``close()`` stops a producer blocked on a
full queue instead of leaving it alive, holding the iterator and its staged
batches. ``batched_index_loader`` turns a sampler's index batches into
collated batches on such a queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class Prefetcher:
    """Wraps a batch iterator with an N-deep background queue."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except Exception as e:   # surfaced on the consumer side
            self._q.put(e)
        self._q.put(self._done)

    def close(self, join_timeout: float = 2.0) -> None:
        """Stop the worker and drop the staged batches. Idempotent."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=join_timeout)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item


def batched_index_loader(dataset, sampler_iter, prefetch_depth: int = 2):
    """Batches of indices -> collated sample batches on a ``Prefetcher``,
    through the dataset's batched ``getitems`` where it has one."""
    from .builder import collate

    def gen():
        for idx in sampler_iter:
            if hasattr(dataset, 'getitems'):
                samples = dataset.getitems([int(i) for i in idx])
            else:
                samples = [dataset[int(i)] for i in idx]
            yield collate(samples)

    return Prefetcher(gen(), depth=prefetch_depth)
