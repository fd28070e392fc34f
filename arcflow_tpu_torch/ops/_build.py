"""Build the port's CUDA kernels at first use and load them with ctypes.

The sources under ``arcflow_tpu_torch/csrc/*.cu`` expose plain C entry
points. They are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library under ``build/arcflow_tpu_torch/`` at the repository root,
named by a hash of the sources and flags, so a changed source builds anew
and an unchanged one is loaded as it is. Importing this module needs no
``nvcc``; only a CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'arcflow_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or the default
    toolkit location."""
    cands = [shutil.which('nvcc')]
    if os.environ.get('CUDA_HOME'):
        cands.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin): the CUDA kernels cannot be built')


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob('*.cu')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libarcflow_kernels-{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for them already exists.

    Writes nvcc's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) beside the library as ``<name>.log``; raises with
    nvcc's stderr when the build fails.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(s) for s in sorted(CSRC_DIR.glob('*.cu'))]
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *sources]
    res = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix('.log').write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed ({res.returncode}): {" ".join(cmd)}'
                           f'\n{res.stderr}')
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures
    (pointers and the stream as ``c_void_p``, or ctypes would cut them to
    32 bits)."""
    lib = ctypes.CDLL(str(build()))
    lib.arcflow_attention_fwd.argtypes = [_P] * 6 + [_I32] * 3 + [_I64] * 13 \
        + [_P]
    lib.arcflow_attention_fwd.restype = _I32
    lib.arcflow_cuda_error_string.argtypes = [_I32]
    lib.arcflow_cuda_error_string.restype = ctypes.c_char_p
    return lib
