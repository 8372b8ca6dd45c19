"""Device selection and the hand-written CUDA kernel library.

The CUDA sources under ``csrc/`` are compiled with nvcc into one shared
library with a plain C interface, loaded with ctypes.  The build runs at
first use (never at import: a machine without nvcc imports every module)
and again whenever a source is newer than the library.

This module is the library's one owner.  The modules that call its C
entries declare their argument types (``declare``), which every load of
the library, or of a host build of part of its interface, binds
(``load``).  ``card_library`` prepares each card once; ``launch`` runs a
kernel module's launch on a card's current stream, and ``call`` makes
the C call, turns an error code into a RuntimeError that names the
kernel, and counts the launch in the program's record
(tracing.launch).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess

import torch

from . import tracing

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hifiles_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libhft_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
# name -> (argument types, result type) of the declared C entries
_ENTRIES = {}
_prepared = set()
DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def select_device(device="cuda") -> torch.device:
    """torch.device for ``device``: "cuda" (the default, or "cuda:0")
    means the first GPU and raises when CUDA is missing; never falls back
    to the CPU, which only an explicit "cpu" selects.

    Also turns TF32 off for matmuls and cuDNN: the FR operators lose
    accuracy in TF32 (the counterpart of the JAX package's
    precision="highest")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin)")
    return path


def build_kernels(force: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH when forced or out of date.
    Returns the compiler's report (ptxas register/spill lines), or "" when
    the library was already current."""
    srcs = _sources()
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime,
                                                      srcs))):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in srcs if s.endswith(".cu")]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    return res.stdout + res.stderr


def declare(restype=ctypes.c_int, **entries):
    """Declare C entries of the library, each name with its argument
    types, all with the result type ``restype``; a library already
    loaded has them bound at once."""
    for name, argtypes in entries.items():
        _ENTRIES[name] = (list(argtypes), restype)
    if _lib is not None:
        bind(_lib)


def bind(lib):
    """Set the argument and result types of every declared entry that
    ``lib`` has; returns ``lib``."""
    for name, (argtypes, restype) in _ENTRIES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def load(path) -> ctypes.CDLL:
    """The library at ``path`` (the kernel library, or a host build of
    part of its interface), its declared entries bound."""
    return bind(ctypes.CDLL(str(path)))


declare(hft_volume_prepare=[ctypes.c_int])


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build_kernels()
        _lib = load(LIB_PATH)
    return _lib


def card_library(device) -> ctypes.CDLL:
    """The kernel library, prepared for the card ``device`` once
    (hft_volume_prepare: the volume kernel's shared-memory limits and
    occupancy, set before its first launch or capture there)."""
    lib = kernel_library()
    if device.index not in _prepared:
        with torch.cuda.device(device):
            rc = lib.hft_volume_prepare(device.index)
        if rc != 0:
            raise RuntimeError(f"preparing the kernels on {device} failed: "
                               f"CUDA error {rc}")
        _prepared.add(device.index)
    return lib


def launch(name, device, dtype, run, *args):
    """``run(fn, *args, device index, stream)`` on the card ``device``,
    ``fn`` the C entry hft_<name>_f32 or _f64 by ``dtype`` and the
    stream PyTorch's current one there: a kernel module's launch, which
    fills the entry's arguments and calls it through ``call``.  Returns
    what ``run`` returns."""
    fn = getattr(card_library(device), f"hft_{name}_{DTYPES[dtype]}")
    stream = torch.cuda.current_stream(device).cuda_stream
    # the library's own CUDA runtime selects ``device`` for the launch,
    # which makes it the thread's current card; the guard restores
    # PyTorch's
    with torch.cuda.device(device):
        return run(fn, *args, device.index, stream)


def call(kernel, variant, fn, *args, shapes=None):
    """One launch of the hand kernel ``kernel``: the C entry ``fn`` called
    with ``args``, a RuntimeError naming the kernel on an error code, and
    the launch counted (tracing.launch) as ``variant``, with the (U, E) of
    its segments, ``shapes``, for a kernel that launches segments."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{rc}")
    tracing.launch(kernel, variant, shapes)
