"""Build the port's CUDA kernels at first use and load them with ctypes.

The sources under ``arcflow_tpu_torch/csrc/*.cu`` expose plain C entry
points; ``csrc/*.cuh`` are headers they share (``hopper.cuh``: mbarriers,
TMA, wgmma). Each source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library under ``build/arcflow_tpu_torch/`` at the repository root,
named by a hash of the sources, headers and flags, so a changed source or
header builds anew and an unchanged tree is loaded as it is. The TMA tensor
maps come from libcuda's ``cuTensorMapEncodeTiled``, looked up through
the runtime's ``cudaGetDriverEntryPointByVersion``, so the link needs no
``-lcuda``. Importing this module needs no ``nvcc``; only a CUDA launch
builds. The wrappers also take from here what every TMA entry point shares:
the refusal of broadcast views and the message of an error code.
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
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

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
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob('*.cu'), *CSRC_DIR.glob('*.cuh')]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libarcflow_kernels-{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for them already exists.

    One ``nvcc -c`` per source runs in parallel, then one link. Writes
    nvcc's output (``-Xptxas -v``: registers, shared memory and spills per
    kernel) beside the library as ``<name>.log``; raises with nvcc's stderr
    when a step fails.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f'{lib.stem}.{os.getpid()}'
    objs, procs = [], []
    for src in sorted(CSRC_DIR.glob('*.cu')):
        obj = BUILD_DIR / f'{tag}.{src.stem}.o'
        cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
    steps = [(cmd, *proc.communicate(), proc.returncode)
             for cmd, proc in procs]
    if all(rc == 0 for *_, rc in steps):
        cmd = [nvcc, '-shared', '-o', str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        steps.append((cmd, res.stdout, res.stderr, res.returncode))
    lib.with_suffix('.log').write_text(''.join(
        out + err for _, out, err, _ in steps))
    for obj in objs:
        obj.unlink(missing_ok=True)
    for cmd, _, err, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f'nvcc failed ({rc}): {" ".join(cmd)}\n{err}')
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
    lib.arcflow_attention_bwd.argtypes = [_P] * 11 + [_I32] * 3 + [
        ctypes.POINTER(_I64), _I64, _P]
    lib.arcflow_attention_bwd.restype = _I32
    lib.arcflow_attention_bwd_workspace_bytes.argtypes = [_I32] * 3
    lib.arcflow_attention_bwd_workspace_bytes.restype = _I64
    lib.arcflow_w4a8_matmul.argtypes = [_P] * 5 + [_I32] * 6 + [_P]
    lib.arcflow_w4a8_matmul.restype = _I32
    lib.arcflow_gm_inverse_cdf.argtypes = [_P] * 7 + [
        ctypes.POINTER(_I64), _I32, _I32, _I64, _I32] \
        + [ctypes.c_float] * 2 + [_I32] * 2 + [_P]
    lib.arcflow_gm_inverse_cdf.restype = _I32
    lib.arcflow_ring_hop.argtypes = [_P] * 8 + [_I32] * 4 + [_I64] * 13 \
        + [_I32] * 2 + [_P]
    lib.arcflow_ring_hop.restype = _I32
    lib.arcflow_flash_int8.argtypes = [_P] * 7 + [_I32] * 4 + [_I64] * 14 \
        + [ctypes.c_float, _P]
    lib.arcflow_flash_int8.restype = _I32
    lib.arcflow_quantize_rows_int8.argtypes = [_P] * 2 + [_I32] * 4 \
        + [_I64] * 6 + [_P] * 5
    lib.arcflow_quantize_rows_int8.restype = _I32
    lib.arcflow_cuda_error_string.argtypes = [_I32]
    lib.arcflow_cuda_error_string.restype = ctypes.c_char_p
    return lib


# An entry point's code for a TMA map that the driver refused
# (csrc/hopper.cuh:kTmaRefused): this base + (pointer argument << 12) + the
# CUresult; smaller codes are CUDA's own.
_TMA_REFUSED = 1 << 20


def launch_error(lib, err: int, args) -> str:
    """The message of an entry point's error code ``err``; ``args`` names
    its pointer arguments in order."""
    if err >= _TMA_REFUSED:
        arg, code = divmod(err - _TMA_REFUSED, 1 << 12)
        return (f'the driver refused the TMA map of {args[arg]} '
                f'(CUresult {code})')
    return lib.arcflow_cuda_error_string(err).decode()


def is_broadcast(t) -> bool:
    """Whether the tensor ``t`` has a zero stride on a dimension of more than one
    element (a broadcast view)."""
    return any(st == 0 and n > 1 for st, n in zip(t.stride(), t.shape))


def check_no_broadcast(**tensors):
    """Refuse broadcast views: the kernels' TMA maps step through memory by
    the strides, and the driver may refuse a zero one."""
    for name, t in tensors.items():
        if is_broadcast(t):
            raise ValueError(f'{name} is a broadcast view (strides '
                             f'{t.stride()}); make it contiguous')
