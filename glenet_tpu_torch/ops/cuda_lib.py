"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, at first use, into `_build/` beside the
package (listed in `.gitignore`), and loaded with ctypes.  The library's file
name carries a hash of its source, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is built or imported when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda'))
    cand = cuda_home / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels build only where the '
                       'CUDA toolkit is installed')


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f'lib{name}-{digest[:12]}.so'


def start_build(name: str, verbose: bool = False):
    """Start nvcc for one source; returns (Popen or None if built, path)."""
    out = library_path(name)
    if out.exists():
        return None, out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *NVCC_FLAGS, *(['-Xptxas', '-v'] if verbose else []),
           '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_build(proc, out: Path) -> str:
    """Wait for a build from start_build; returns nvcc's output."""
    if proc is None:
        return ''
    log, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index('-o') + 1])
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {out.name}:\n{log}')
    os.replace(tmp, out)
    return log


def build_all(names, verbose: bool = False) -> dict:
    """Build several kernels with one nvcc each, all started together."""
    started = {n: start_build(n, verbose) for n in names}
    return {n: finish_build(*started[n]) for n in names}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; `signatures` maps each C
    function to (argtypes, restype)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            finish_build(*start_build(name))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
