"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file (with the headers ``csrc/*.cuh`` they share) is
compiled into one shared library with a plain C interface, at first use, for
Hopper: one nvcc per source, all started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c -o <src>.o csrc/<src>.cu     # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> *.o

No ``--use_fast_math``: the LSTM kernel's tolerance needs the accurate
``expf``/``tanhf``. The library lands in ``build/kernels/`` beside the package
under a name that carries a hash of the sources and flags, so an edit rebuilds
and an unchanged tree reuses it. A failed build raises with nvcc's stderr.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas=-v']
LINK_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-shared']

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class BuildInfo:
    """What the last build or load did: seconds spent, whether nvcc ran, and
    nvcc's output (``-Xptxas=-v`` lists registers, shared memory and spills
    per kernel)."""
    seconds = 0.0
    compiled = False
    log = ''
    path = ''


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels cannot be built')


def _sources():
    return sorted(CSRC.glob('*.cu'))


def _library_path() -> Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob('*.cu*')):   # the sources and the headers they share
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f'libencodec_kernels_{digest.hexdigest()[:16]}.so'


def _compile(out: Path) -> str:
    """One nvcc per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f'{out.stem}.{os.getpid()}'
    objs, procs = [], []
    for src in _sources():
        obj = out.parent / f'{tag}.{src.stem}.o'
        cmd = [_nvcc(), *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        logs.append(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stderr}")
    tmp = out.with_name(f'{tag}.tmp')
    if not failed:
        cmd = [_nvcc(), *LINK_FLAGS, '-o', str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                          f"{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError('\n'.join(failed))
    os.replace(tmp, out)
    return ''.join(logs)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.encodec_rvq_encode_f32.restype = i
    lib.encodec_rvq_encode_f32.argtypes = [p, ll, ll, ll, i, p, p, p] + [i] * 5 + [p]
    lib.encodec_rvq_config.restype = None
    lib.encodec_rvq_config.argtypes = [i, i, p, p, p]
    lib.encodec_lstm_recurrence_f32.restype = i
    lib.encodec_lstm_recurrence_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p]
    lib.encodec_lstm_recurrence_i8w.restype = i
    lib.encodec_lstm_recurrence_i8w.argtypes = [p] * 7 + [i] * 4 + [p, p]
    lib.encodec_disc_conv_fwd_f32.restype = i
    lib.encodec_disc_conv_fwd_f32.argtypes = [p, p, p, p] + [i] * 12 + [p]
    lib.encodec_disc_conv_dx_f32.restype = i
    lib.encodec_disc_conv_dx_f32.argtypes = [p, p, p] + [i] * 12 + [p]
    lib.encodec_disc_conv_pack_f32.restype = i
    lib.encodec_disc_conv_pack_f32.argtypes = [p, p] + [i] * 7 + [p]
    lib.encodec_disc_im2col_fwd_f32.restype = i
    lib.encodec_disc_im2col_fwd_f32.argtypes = [p, p, p, p] + [i] * 10 + [p]
    lib.encodec_disc_im2col_pack_f32.restype = i
    lib.encodec_disc_im2col_pack_f32.argtypes = [p, p, p]
    lib.encodec_disc_conv_fwd_bf16.restype = i
    lib.encodec_disc_conv_fwd_bf16.argtypes = [p, p, p, p] + [i] * 12 + [p]
    lib.encodec_disc_conv_dx_bf16.restype = i
    lib.encodec_disc_conv_dx_bf16.argtypes = [p, p, p] + [i] * 12 + [p]
    lib.encodec_disc_conv_pack_bf16.restype = i
    lib.encodec_disc_conv_pack_bf16.argtypes = [p, p] + [i] * 7 + [p]
    lib.encodec_disc_im2col_fwd_bf16.restype = i
    lib.encodec_disc_im2col_fwd_bf16.argtypes = [p, p, p, p] + [i] * 10 + [p]
    lib.encodec_disc_im2col_pack_bf16.restype = i
    lib.encodec_disc_im2col_pack_bf16.argtypes = [p, p, p]
    lib.encodec_resblock_f32.restype = i
    lib.encodec_resblock_f32.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.encodec_resblock_i8w.restype = i
    lib.encodec_resblock_i8w.argtypes = [p] * 13 + [i] * 8 + [p]
    lib.encodec_resblock_config.restype = None
    lib.encodec_resblock_config.argtypes = [i, i, p, p]
    lib.encodec_lm_coder_f32.restype = i
    lib.encodec_lm_coder_f32.argtypes = [i, p, i, i, i, ctypes.c_float, p, p, p, ll, ll, i, p,
                                         i, p]
    lib.encodec_lm_coder_floor.restype = i
    lib.encodec_lm_coder_floor.argtypes = [i, i, i, i, p]
    lib.encodec_cuda_error_string.restype = ctypes.c_char_p
    lib.encodec_cuda_error_string.argtypes = [i]


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        start = time.perf_counter()
        path = _library_path()
        if not path.exists():
            BuildInfo.log = _compile(path)
            BuildInfo.compiled = True
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        BuildInfo.seconds = time.perf_counter() - start
        BuildInfo.path = str(path)
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        msg = load().encodec_cuda_error_string(rc).decode()
        raise RuntimeError(f'{what} failed: CUDA error {rc} ({msg})')
