"""Device selection and the hand-written CUDA kernel library.

The CUDA sources under ``csrc/`` are compiled with nvcc into one shared
library with a plain C interface, loaded with ctypes.  The build runs at
first use (never at import: a machine without nvcc imports every module)
and again whenever a source is newer than the library.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hifiles_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libhft_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


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


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build_kernels()
        _lib = ctypes.CDLL(LIB_PATH)
    return _lib
