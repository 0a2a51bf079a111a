"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into a shared
library with a plain C interface, loaded with ctypes.  A library is built
at first use into ``_build/`` beside this package (listed in .gitignore),
named by a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source rebuilds.
:func:`build` compiles several sources at once, one nvcc process each.
``defines`` (``NAME=VALUE`` strings, passed as ``-D``) build a variant of a
source beside the shipped one; only the experiment tools ask for them.
Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points of each source and their argument types (pointers and the
# stream as c_void_p: a plain int argument would cut them to 32 bits)
SIGNATURES: Dict[str, Dict[str, list]] = {
    'bin_sum': {'sf_bin_sum':
                [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _I, _I, _P]},
    'bin_sum_grouped': {'sf_bin_sum_grouped':
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _I,
                         _I, _I, _P]},
    'patch_pool': {
        'sf_patch_pool':
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        'sf_patch_pool_bwd':
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    'winfuse': {'sf_winfuse_fp32': [_P, _P, _P, _P, _I, _I, _I, _I, _P],
                'sf_winfuse_bf16': [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
}

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, Tuple[str, ...]], ctypes._CFuncPtr] = {}
# ptxas report (registers, shared memory, spills) of each library, from
# its build in this process or from the log kept beside it
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


def _flags(defines: Tuple[str, ...]) -> list:
    return NVCC_FLAGS + [f'-D{d}' for d in defines]


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    for header in sorted(CSRC.glob('*.cuh')):
        src += header.read_bytes()
    tag = hashlib.sha256(src + ' '.join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}_{tag[:16]}.so'


def build(names: Iterable[str] = tuple(SIGNATURES),
          defines: Tuple[str, ...] = ()) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all nvcc processes
    started together.  Raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, procs = {}, {}
    for name in names:
        out = library_path(name, defines)
        paths[name] = out
        if out.exists():
            log = out.with_suffix('.log')
            if log.exists():
                BUILD_LOG[' '.join((name, *defines))] = log.read_text()
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *_flags(defines), '-o', str(tmp),
             str(CSRC / f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[' '.join((name, *defines))] = log
        if proc.returncode != 0:
            failed.append(f'--- {name} ---\n{log}')
            tmp.unlink(missing_ok=True)
        else:
            paths[name].with_suffix('.log').write_text(log)
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return paths


def kernel(name: str, symbol: Optional[str] = None,
           defines: Tuple[str, ...] = ()):
    """C entry point ``symbol`` (``sf_<name>`` unless given) of
    ``csrc/<name>.cu`` built with ``defines``, building the source if
    needed.  It returns a cudaError_t as int (0 = success)."""
    symbol = symbol or f'sf_{name}'
    fn = _FUNCS.get((symbol, defines))
    if fn is None:
        argtypes = SIGNATURES[name][symbol]
        if (name, defines) not in _LIBS:
            _LIBS[name, defines] = ctypes.CDLL(
                str(build([name], defines)[name]))
        fn = getattr(_LIBS[name, defines], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[symbol, defines] = fn
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: '
                           f'cudaError {err}')
