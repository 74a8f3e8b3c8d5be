"""Lazy ``nvcc`` build of ``repro_torch/csrc/*.cu`` into ``ctypes`` libraries.

Each source compiles on its own into ``build/kernels/<name>.<hash>.so`` at
the checkout root with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>.<hash>.so csrc/<name>.cu

The library exposes a plain C interface (no PyTorch headers), so a build
takes seconds.  Builds run at the first CUDA launch of a kernel (``load``),
or all at once in parallel (``build_all``).  The library file is named by
the hash of the source and of every header under ``csrc`` (``*.cuh``, which
sources include by name), so an unchanged source is not rebuilt, and a loaded
library is kept for the life of the process (the source is hashed once, at
its first load, not at every launch).  A failed build raises.  Every exported
function returns an ``int`` CUDA error code; pointers and the stream are
declared ``c_void_p`` and integers ``c_int``.

``DEFINES`` maps a source to extra ``nvcc`` flags for a debug build (for
example ``-DCLOCK_STAMPS``, ``csrc/clock_stamps.cuh``); they enter the hash,
so a debug build is a library of its own, loaded beside the plain one.
"""
from __future__ import annotations

import ctypes
import hashlib
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, Sequence, Tuple

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

P = ctypes.c_void_p     # device pointer or cudaStream_t
I = ctypes.c_int

# (name, extra flags) -> loaded library; one entry per build per process
_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
# name -> extra nvcc flags of its debug build (none by default)
DEFINES: Dict[str, Tuple[str, ...]] = {}


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not pathlib.Path(path).exists():
        raise RuntimeError('nvcc not found: the CUDA kernels are built on '
                           'a machine with the CUDA toolkit')
    return path


def _target(name: str) -> Tuple[pathlib.Path, str, pathlib.Path]:
    src = CSRC / f'{name}.cu'
    h = hashlib.sha256(src.read_bytes())
    for flag in DEFINES.get(name, ()):
        h.update(flag.encode())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return src, digest, BUILD_DIR / f'{name}.{digest}.so'


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no library for its current
    hash, one ``nvcc`` process per source, all started together.  Raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        src, _, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix('.tmp.so')
        cmd = [_nvcc(), *NVCC_FLAGS, *DEFINES.get(name, ()), '-o',
               str(tmp), str(src)]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, out, proc in procs:
        log = proc.communicate()[0].decode(errors='replace')
        if proc.returncode != 0:
            failed.append(f'{name}:\n{log}')
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError('nvcc build failed for ' + '\n'.join(failed))


def build_all() -> Sequence[str]:
    """Build every source under ``csrc`` in parallel; returns the names."""
    names = sorted(p.stem for p in CSRC.glob('*.cu'))
    build(names)
    return names


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each exported function to its ``argtypes``; every
    function's ``restype`` is ``c_int`` (a CUDA error code).  The build
    with ``DEFINES[name]``, when given."""
    key = (name, DEFINES.get(name, ()))
    if key in _LIBS:
        return _LIBS[key]
    _, _, out = _target(name)
    build([name])
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LIBS[key] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise ``RuntimeError`` when a kernel library call returned a nonzero
    CUDA error code (every library exports ``kernel_error_string``)."""
    if err != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f'{what} failed: CUDA error {err} ({msg})')
