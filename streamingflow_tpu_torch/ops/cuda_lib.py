"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into a shared
library with a plain C interface, loaded with ctypes.  A library is built
at first use into ``_build/`` beside this package (listed in .gitignore),
named by a hash of its source and flags, so an edited source rebuilds.
:func:`build` compiles several sources at once, one nvcc process each.
Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point of each source and its argument types (pointers and the
# stream as c_void_p: a plain int argument would cut them to 32 bits)
SIGNATURES: Dict[str, Tuple[str, list]] = {
    'bin_sum': ('sf_bin_sum', [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    'patch_pool': ('sf_patch_pool',
                   [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
}

_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
# ptxas report (registers, shared memory, spills) of each build
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit to build')


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    tag = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}_{tag[:16]}.so'


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all nvcc processes
    started together.  Raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, procs = {}, {}
    for name in names:
        out = library_path(name)
        paths[name] = out
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f'--- {name} ---\n{log}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return paths


def kernel(name: str):
    """The C entry point of ``csrc/<name>.cu``, building it if needed.  It
    returns a cudaError_t as int (0 = success)."""
    fn = _FUNCS.get(name)
    if fn is None:
        symbol, argtypes = SIGNATURES[name]
        lib = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: '
                           f'cudaError {err}')
