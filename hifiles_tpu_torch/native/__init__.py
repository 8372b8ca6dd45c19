"""ctypes bindings for the native mesh-preprocessing kernels.

The shared library is compiled from mesh_kernels.cc on first use (g++ -O3)
into build/hifiles_tpu_torch/ beside the CUDA kernel library.  Everything
has a pure-numpy fallback — set HIFILES_NO_NATIVE=1 to force it (used by
tests to compare both paths).  This is host preprocessing with results
identical to the numpy path, not a device kernel.

Copied from hifiles_tpu/native/__init__.py (lines 1-127); the library is
built outside the source tree, through a temporary file renamed into
place so that concurrent first uses never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mesh_kernels.cc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                      "hifiles_tpu_torch")
_LIB = os.path.join(_BUILD, "libhfmesh.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("HIFILES_NO_NATIVE"):
        return None
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, _LIB)
        _lib = ctypes.CDLL(_LIB)
        i64 = ctypes.POINTER(ctypes.c_int64)
        f64 = ctypes.POINTER(ctypes.c_double)
        _lib.hf_build_faces.restype = ctypes.c_int
        _lib.hf_build_faces.argtypes = [ctypes.c_int64, i64, i64, i64, i64,
                                        i64, i64, i64, i64]
        _lib.hf_match_fpts.restype = ctypes.c_int64
        _lib.hf_match_fpts.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, f64, f64,
                                       ctypes.c_double, i64]
        _lib.hf_partition.restype = None
        _lib.hf_partition.argtypes = [ctypes.c_int64, i64, i64,
                                      ctypes.c_int64, i64]
    except Exception as e:  # pragma: no cover - toolchain missing
        print(f"hifiles_tpu_torch.native: falling back to numpy ({e})",
              file=sys.stderr)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr_i(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptr_d(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def build_faces_native(face_cell, face_locf, face_nv, face_verts):
    """Interior-face hash matching.  face_verts (Nf, 4) corner ids (-1 pad).

    Returns (int_faces (Ni, 6) [l, kl, r, kr, rtag, nv], unmatched row ids)
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n_f = len(face_cell)
    fc, fl = _i64(face_cell), _i64(face_locf)
    fn, fv = _i64(face_nv), _i64(face_verts)
    int_out = np.empty((n_f // 2 + 1, 6), dtype=np.int64)
    unmatched = np.empty(n_f, dtype=np.int64)
    n_int = np.zeros(1, dtype=np.int64)
    n_un = np.zeros(1, dtype=np.int64)
    rc = lib.hf_build_faces(n_f, _ptr_i(fc), _ptr_i(fl), _ptr_i(fn),
                            _ptr_i(fv), _ptr_i(int_out), _ptr_i(n_int),
                            _ptr_i(unmatched), _ptr_i(n_un))
    if rc != 0:
        raise ValueError("faces share vertices but no orientation match")
    return int_out[:n_int[0]].copy(), unmatched[:n_un[0]].copy()


def match_fpts_native(pos_l, pos_r, tol=1e-7):
    """Batched geometric flux-point matching; pos_* (F, nfp, d).
    Returns perm (F, nfp) or None when unavailable; raises on mismatch."""
    lib = _load()
    if lib is None:
        return None
    pl = np.ascontiguousarray(pos_l, dtype=np.float64)
    pr = np.ascontiguousarray(pos_r, dtype=np.float64)
    F, nfp, d = pl.shape
    perm = np.empty((F, nfp), dtype=np.int64)
    bad = lib.hf_match_fpts(F, nfp, d, _ptr_d(pl), _ptr_d(pr),
                            float(tol), _ptr_i(perm))
    if bad >= 0:
        raise AssertionError(
            f"face flux points do not coincide (face row {bad})")
    return perm


def partition_native(xadj, adjncy, n_parts):
    """Balanced greedy-BFS mesh partition; returns part id per cell or
    None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    xa, ad = _i64(xadj), _i64(adjncy)
    n_cells = len(xa) - 1
    part = np.empty(n_cells, dtype=np.int64)
    lib.hf_partition(n_cells, _ptr_i(xa), _ptr_i(ad), int(n_parts),
                     _ptr_i(part))
    return part
