"""File I/O: retried transfers, file backends keyed by URI scheme, the
per-host download gate and image files.

The port's own copy of ``arcflow_tpu/utils/io_utils.py`` (that module
imports no JAX, but the port imports nothing of the JAX package):

* ``retry``: a decorator that calls again, after a delay, on an error;
* backends with ``get`` / ``put`` (bytes) / ``exists`` / ``join_path``,
  the remote ones with ``get_file`` (and S3 with ``put_file``: a file on
  the local disk, streamed, since a checkpoint file may be larger than a
  host's memory and than one S3 PUT takes): local files, ``http(s)://``
  (urllib), ``s3://`` (boto3, imported when the first ``s3://`` path is
  met; refused by name without it) and
  ``huggingface://org/repo/path`` (``huggingface_hub``'s local cache only:
  nothing is downloaded, where JAX's backend may reach for the hub);
* ``uri_scheme`` / ``get_file_backend`` map a path to its backend, one
  instance per scheme; ``register_backend`` puts an instance in its place
  (tests fake remote storage on the local disk with it);
* ``local_file``: a path on the local disk holding a remote file's bytes;
* ``is_node_local_rank_zero``: one process per host fetches (``LOCAL_RANK``,
  as ``torch.distributed.run`` sets it);
* ``save_image`` / ``load_image`` / ``save_image_grid``: PIL and numpy, the
  same PNG bytes as JAX's for the same arrays (a tensor is taken too).
"""

from __future__ import annotations

import contextlib
import functools
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np


def retry(tries: int = 5, delay: float = 3.0, backoff: float = 1.0,
          exceptions=(Exception,)):
    """Call the function again on one of ``exceptions``, up to ``tries``
    times, ``delay`` seconds apart (times ``backoff`` after each); the last
    error propagates."""
    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            wait = delay
            for attempt in range(tries):
                try:
                    return fn(*args, **kwargs)
                except exceptions:
                    if attempt == tries - 1:
                        raise
                    time.sleep(wait)
                    wait *= backoff
        return wrapped
    return deco


class LocalBackend:
    def get(self, path: str) -> bytes:
        with open(path, 'rb') as f:
            return f.read()

    def put(self, data: bytes, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'wb') as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def join_path(self, *parts) -> str:
        return os.path.join(*parts)


class HTTPBackend:
    @retry(tries=5, delay=3)
    def get(self, url: str) -> bytes:
        import urllib.request
        with urllib.request.urlopen(url) as r:
            return r.read()

    @retry(tries=5, delay=3)
    def get_file(self, url: str, local_path: str):
        import urllib.request
        with urllib.request.urlopen(url) as r, open(local_path, 'wb') as f:
            shutil.copyfileobj(r, f)

    def exists(self, url: str) -> bool:
        import urllib.request
        try:
            urllib.request.urlopen(url)
            return True
        except Exception:
            return False

    def join_path(self, *parts) -> str:
        return '/'.join(p.strip('/') for p in parts)


class S3Backend:
    """``s3://bucket/key`` through a boto3 client."""

    def __init__(self):
        try:
            import boto3
        except ImportError as e:
            raise RuntimeError('s3:// paths need boto3, which is not '
                               'installed here') from e
        self.client = boto3.client('s3')

    @staticmethod
    def _split(path: str):
        bucket, _, key = path[len('s3://'):].partition('/')
        return bucket, key

    @retry(tries=5, delay=3)
    def get(self, path: str) -> bytes:
        bucket, key = self._split(path)
        return self.client.get_object(Bucket=bucket, Key=key)['Body'].read()

    @retry(tries=5, delay=3)
    def put(self, data: bytes, path: str):
        bucket, key = self._split(path)
        self.client.put_object(Bucket=bucket, Key=key, Body=data)

    # boto3's managed transfers: multipart above 8 MB (one PUT takes at most
    # 5 GB), each part retried on its own
    def get_file(self, path: str, local_path: str):
        bucket, key = self._split(path)
        self.client.download_file(bucket, key, local_path)

    def put_file(self, local_path: str, path: str):
        bucket, key = self._split(path)
        self.client.upload_file(local_path, bucket, key)

    def exists(self, path: str) -> bool:
        bucket, key = self._split(path)
        try:
            self.client.head_object(Bucket=bucket, Key=key)
            return True
        except Exception:
            return False

    def join_path(self, *parts) -> str:
        return '/'.join(p.rstrip('/') for p in parts)


class HuggingFaceBackend:
    """``huggingface://org/repo/path/in/repo`` resolved in
    ``huggingface_hub``'s local cache (``HF_HOME``), with
    ``local_files_only``: a file not in the cache is absent."""

    def __init__(self):
        try:
            from huggingface_hub import hf_hub_download
        except ImportError as e:
            raise RuntimeError('huggingface:// paths need huggingface_hub, '
                               'which is not installed here') from e
        self._download = hf_hub_download

    @staticmethod
    def parse(path: str):
        parts = path[len('huggingface://'):].split('/')
        return '/'.join(parts[:2]), '/'.join(parts[2:])

    def local_path(self, path: str) -> str:
        repo_id, filename = self.parse(path)
        return self._download(repo_id=repo_id, filename=filename,
                              local_files_only=True)

    def get(self, path: str) -> bytes:
        with open(self.local_path(path), 'rb') as f:
            return f.read()

    def get_file(self, path: str, local_path: str):
        shutil.copyfile(self.local_path(path), local_path)

    def exists(self, path: str) -> bool:
        try:
            self.local_path(path)
            return True
        except Exception:
            return False

    def join_path(self, *parts) -> str:
        return '/'.join(p.rstrip('/') for p in parts)


_BACKENDS: Dict[str, object] = {}
_CONSTRUCTORS = {'s3': S3Backend, 'http': HTTPBackend,
                 'huggingface': HuggingFaceBackend, 'local': LocalBackend}


def register_backend(scheme: str, backend) -> None:
    """Serve ``scheme``'s paths with ``backend`` (an instance); take it out
    again with ``_BACKENDS.pop(scheme)``."""
    _BACKENDS[scheme] = backend


def uri_scheme(path: str) -> str:
    if path.startswith('s3://'):
        return 's3'
    if path.startswith('huggingface://'):
        return 'huggingface'
    if path.startswith(('http://', 'https://')):
        return 'http'
    return 'local'


def get_file_backend(path: str):
    """The backend of ``path``'s scheme, made on first use."""
    scheme = uri_scheme(path)
    if scheme not in _BACKENDS:
        _BACKENDS[scheme] = _CONSTRUCTORS[scheme]()
    return _BACKENDS[scheme]


@contextlib.contextmanager
def local_file(path: str, suffix: str = ''):
    """A local file with ``path``'s bytes, for the ``with`` block: the path
    itself when local, the backend's cached file when it has one
    (``local_path``), else a temporary file (under
    ``tempfile.gettempdir()``) removed at the end of the block."""
    if uri_scheme(path) == 'local':
        yield path
        return
    backend = get_file_backend(path)
    if hasattr(backend, 'local_path'):
        yield backend.local_path(path)
        return
    fd, tmp = tempfile.mkstemp(suffix=suffix, prefix='arcflow-')
    os.close(fd)
    try:
        backend.get_file(path, tmp)
        yield tmp
    finally:
        os.remove(tmp)


def is_node_local_rank_zero() -> bool:
    """Whether this process fetches for its host: ``LOCAL_RANK`` 0 (or
    unset, one process)."""
    return int(os.environ.get('LOCAL_RANK', 0)) == 0


def _numpy(img) -> np.ndarray:
    if hasattr(img, 'detach'):
        img = img.detach().to('cpu')
        if img.is_floating_point():
            img = img.float()
        img = img.numpy()
    return np.asarray(img)


def save_image(img, path: str):
    """(H, W, 3) float in [0, 1] (rounded to uint8) or uint8 -> an image
    file, its format from the extension."""
    from PIL import Image
    img = _numpy(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(img).save(path)


def load_image(path: str, backend=None) -> np.ndarray:
    """An image file (any backend) -> (H, W, 3) uint8 RGB."""
    from io import BytesIO
    from PIL import Image
    backend = backend or get_file_backend(path)
    return np.asarray(Image.open(BytesIO(backend.get(path))).convert('RGB'))


def save_image_grid(images, path: str, ncols: Optional[int] = None):
    """(N, H, W, 3) -> one image of the N tiled row by row, ``ncols``
    (ceil(sqrt(N)) by default) to a row, empty cells black."""
    images = _numpy(images)
    n, h, w, c = images.shape
    ncols = ncols or int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    grid = np.zeros((nrows * h, ncols * w, c), images.dtype)
    for i in range(n):
        r, cc = divmod(i, ncols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = images[i]
    save_image(grid, path)
