"""Host-side geometry of the data pipeline in C++ (native/host_ops.cpp):
point-in-rotated-box masks for gt-database creation and gt sampling, and
the BEV rectangle collision test, with their plain numpy versions beside
them.

The library is built from the repository's `native/host_ops.cpp` with g++
at first use into `_build/` beside the package (listed in `.gitignore`),
under a name that carries a hash of the source and flags, and loaded with
ctypes.  The committed `native/libglenet_host.so` is never loaded: its
Makefile builds with `-march=native` on the machine that ran it, so on
another host CPU it may stop with an illegal instruction.  The port's flags
name no machine, and `-ffp-contract=off` keeps the compiler from fusing
multiplies and adds, so the library does the numpy versions' arithmetic.
Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from . import cuda_lib

SOURCE = Path(__file__).resolve().parents[2] / 'native' / 'host_ops.cpp'
CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17', '-ffp-contract=off')

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + ' '.join(CXX_FLAGS).encode()).hexdigest()
    return cuda_lib.BUILD / f'libglenet_host-{digest[:12]}.so'


def load() -> ctypes.CDLL:
    """Build (if needed) and load the host library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            cxx = shutil.which('g++')
            if cxx is None:
                raise RuntimeError('g++ not found: the host library of the '
                                   'data pipeline builds with g++')
            cuda_lib.BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f'.{os.getpid()}.tmp')
            proc = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'g++ failed for {SOURCE.name}:\n'
                                   f'{proc.stdout}{proc.stderr}')
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
        for fn in (lib.points_in_rboxes, lib.rbox_collision):
            fn.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, u8p]
            fn.restype = None
        _lib = lib
        return lib


def _boxes(boxes):
    return np.ascontiguousarray(np.asarray(boxes)[:, :7], np.float32)


def points_in_rboxes(points, boxes):
    """(N, 3+) x (M, 7) -> (N, M) bool: point inside the rotated box (z
    within dz / 2, exact rotated xy)."""
    points = np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)
    boxes = _boxes(boxes)
    n, m = len(points), len(boxes)
    if not (n and m):
        return np.zeros((n, m), bool)
    out = np.empty((n, m), np.uint8)
    load().points_in_rboxes(points, n, boxes, m, out)
    return out.astype(bool)


def points_in_rboxes_plain(points, boxes):
    from ..utils import box_utils
    return box_utils.points_in_boxes_np(
        np.asarray(points, np.float32)[:, :3], _boxes(boxes))


def rbox_collision(boxes_a, boxes_b):
    """(A, 7) x (B, 7) -> (A, B) bool: the BEV rectangles overlap (separating
    axis test)."""
    a, b = _boxes(boxes_a), _boxes(boxes_b)
    na, nb = len(a), len(b)
    if not (na and nb):
        return np.zeros((na, nb), bool)
    out = np.empty((na, nb), np.uint8)
    load().rbox_collision(a, na, b, nb, out)
    return out.astype(bool)


def rbox_collision_plain(boxes_a, boxes_b):
    from ..datasets import augmentor_utils as au
    a, b = _boxes(boxes_a), _boxes(boxes_b)
    if not (len(a) and len(b)):
        return np.zeros((len(a), len(b)), bool)
    return au._sat_overlap(au._bev_corners(a[:, [0, 1, 3, 4, 6]]),
                           au._bev_corners(b[:, [0, 1, 3, 4, 6]]))
