"""The native batched record loader, built at first use.

The port's own copy of ``arcflow_tpu/data/_fastloader`` (it imports no
JAX): ``fastloader.cpp`` is a CPython extension that reads a batch of
files and zstd-decompresses them on a pool of threads with the GIL
released, ``load_batch(paths, num_threads=0, decompress=True) ->
list[bytes]`` (0 threads: one per core), raising ``IOError`` on a missing
or truncated record. It links libzstd's C library, so it reads the
``ImagePrompt`` cache where the Python ``zstandard`` package is absent.

``get_fastloader()`` compiles it once per process with ``g++ -O3
-std=c++17 -shared -fPIC ... -lzstd -lpthread`` into the port's build
directory (``build/arcflow_tpu_torch/`` at the repository root, beside the
CUDA kernels, named by a hash of the source, the command and the
interpreter's extension suffix, so an unchanged source is loaded as it
is), and returns the module, or None where ``g++``, Python's headers or
zstd's header and library are missing, as the JAX package does; the
callers then read record by record. ``unavailable_reason()`` says why it
returned None.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path
from typing import Optional

from ...ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / 'fastloader.cpp'
NAME = '_arcflow_fastloader'

_LOCK = threading.Lock()
_MODULE = None
_TRIED = False
_REASON: Optional[str] = None


def _command(out: str):
    include = sysconfig.get_paths()['include']
    return ['g++', '-O3', '-std=c++17', '-shared', '-fPIC', f'-I{include}',
            str(SOURCE), '-lzstd', '-lpthread', '-o', out]


def library_path() -> Path:
    """Where the extension for the current source and interpreter lives."""
    suffix = sysconfig.get_config_var('EXT_SUFFIX') or '.so'
    h = hashlib.sha256(' '.join(_command('')).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f'{NAME}-{h.hexdigest()[:16]}{suffix}'


def _build_and_load():
    out = library_path()
    if not out.exists():
        if shutil.which('g++') is None:
            raise RuntimeError('g++ not found on PATH')
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build beside the target and rename: processes that build at once
        # (test workers, ranks) never load a half-written file
        fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(_command(tmp), capture_output=True,
                                 text=True)
            if res.returncode != 0:
                tail = (res.stderr or res.stdout).strip().splitlines()[-3:]
                raise RuntimeError('g++ failed: ' + ' | '.join(tail))
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    spec = importlib.util.spec_from_file_location(NAME, out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_fastloader():
    """The native module, or None when the toolchain or zstd is missing
    (``unavailable_reason`` says which)."""
    global _MODULE, _TRIED, _REASON
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                _MODULE = _build_and_load()
            except Exception as e:
                _MODULE = None
                _REASON = f'{type(e).__name__}: {e}'
        return _MODULE


def unavailable_reason() -> Optional[str]:
    """Why ``get_fastloader`` returned None (None before its first call,
    or when it built)."""
    return _REASON
