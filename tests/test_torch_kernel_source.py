"""The CUDA source of the volume kernel (hifiles_tpu_torch/csrc/
volume_tdisf.cu), compiled for the CPU by g++ with a stand-in for the CUDA
runtime that runs each launch's grid serially, against the plain version
on every instantiation (d = 2 and 3, F = d+2 and d+3, SGS none,
Smagorinsky and WALE, inviscid part on and off) and flag (viscous,
Sutherland, added flux), in f32 and f64 with broadcast and full geometry.

This holds the kernel's arithmetic and indexing on a machine without a
card; chip_smoke.py holds the kernel as nvcc builds it on the card."""

import ctypes
import dataclasses
import itertools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hifiles_tpu_torch.backend import CSRC
from hifiles_tpu_torch.solver import volume as V

torch.set_num_threads(1)

# the CUDA runtime as far as volume_tdisf.cu uses it, on the host
RUNTIME = r"""
#pragma once
#include <cmath>
#include <cstdint>
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx, blockDim;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
inline float sqrtf(float x) { return std::sqrt(x); }
inline float expf(float x) { return std::exp(x); }
inline float log1pf(float x) { return std::log1p(x); }
using std::exp;
using std::log1p;
using std::sqrt;
"""
LAUNCH = ("  volume_tdisf_kernel<T, D, F, SGS, INV>\n"
          "      <<<static_cast<unsigned int>(blocks), kThreads, 0, "
          "stream>>>(")
SERIAL = ("  blockDim.x = kThreads;\n"
          "  for (int64_t b = 0; b < blocks; ++b)\n"
          "    for (unsigned t = 0; t < kThreads; ++t) {\n"
          "      blockIdx.x = b;\n"
          "      threadIdx.x = t;\n"
          "      volume_tdisf_kernel<T, D, F, SGS, INV>(")
CALL_END = "          a.delta_stride, a.wdist_stride, prm);\n}"


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel library built from the CUDA source for the host."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    src = open(os.path.join(CSRC, "volume_tdisf.cu")).read()
    assert src.count(LAUNCH) == 1 and src.count(CALL_END) == 1
    src = src.replace(LAUNCH, SERIAL).replace(
        CALL_END, CALL_END[:-1] + "    }\n}")
    src = src.replace("#include <cuda_runtime.h>", '#include "runtime.h"')
    d = tmp_path_factory.mktemp("volume_tdisf_host")
    (d / "runtime.h").write_text(RUNTIME)
    (d / "volume_tdisf.cpp").write_text(src)
    lib = d / "libvolume_tdisf_host.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(d), "-o", str(lib),
                    str(d / "volume_tdisf.cpp")], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def run_host(lib, u, grad, jg, prm, delta, wdist, extra):
    """One launch through the library's C entry, with the wrapper's own
    argument struct (volume._Args) and pointers to CPU tensors."""
    V._check(u, grad, jg, prm, delta, wdist, extra)
    U, F, E = u.shape
    D = jg.shape[0]
    sgs = prm.sgs if prm.viscous else V.SGS_NONE
    stride = lambda t: 1 if t is not None and t.shape[-1] == E else 0
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = getattr(lib, "hft_volume_tdisf_f32" if u.dtype == torch.float32
                 else "hft_volume_tdisf_f64")
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.POINTER(V._Args),
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = V._Args(
        n_upts=U, n_eles=E, n_fields=F, n_dims=D, jg_stride=stride(jg),
        delta_stride=stride(delta), wdist_stride=stride(wdist),
        gamma=prm.gamma, prandtl=prm.prandtl, prandtl_t=prm.prandtl_t,
        mu_inf=prm.mu, rt_inf=prm.rt_inf, c_sth=prm.c_sth, c_v1=prm.c_v1,
        omega=prm.omega, C_s=prm.C_s, kappa=prm.kappa,
        viscous=int(prm.viscous), inviscid=int(prm.inviscid),
        sutherland=int(not prm.fix_vis), sgs=sgs)
    out = torch.full((D, U, F, E), float("nan"), dtype=u.dtype)
    rc = fn(ptr(u), ptr(grad) if prm.viscous else None, ptr(jg),
            ptr(delta) if sgs != V.SGS_NONE else None,
            ptr(wdist) if sgs != V.SGS_NONE else None, ptr(extra), ptr(out),
            ctypes.byref(args), 0, None)
    assert rc == 0
    return out


BASE = V.VolumeParams(gamma=1.4, prandtl=0.72, mu=0.05, viscous=True,
                      rt_inf=1.0, c_sth=0.368, prandtl_t=0.9, C_s=0.1,
                      kappa=0.41)
# every template instantiation (sgs, inviscid) with the viscous flux, and
# the inviscid-only launch, each with the SA field or without
CASES = [dict(sgs=sgs, inviscid=inv) for sgs in (V.SGS_NONE,
                                                 V.SGS_SMAGORINSKY,
                                                 V.SGS_WALE)
         for inv in (True, False)] + [dict(viscous=False)]


@pytest.mark.parametrize("sa", [False, True], ids=["ns", "sa"])
@pytest.mark.parametrize("d", [2, 3])
def test_kernel_source_matches_plain_version(host_kernel, d, sa):
    F = d + 2 + int(sa)
    U, E = 7, 33                     # E not a multiple of the block size
    rng = np.random.default_rng(d + 10 * sa)
    u = rng.random((U, F, E)) + 1.0
    u[:, d + 1] += 10.0
    if sa:
        u[:, d + 2] = BASE.mu * rng.uniform(-2.0, 20.0, (U, E))
    grad = rng.normal(size=(d, U, F, E)) * 0.5
    jg = rng.random((d, d, U, E))
    delta = 0.5 + rng.random((U, E))
    wdist = 0.5 * rng.random((U, E))
    extra = rng.normal(size=(d, U, F, E)) * 0.1
    n = 0
    for case, fix_vis, add, dtype, geo in itertools.product(
            CASES, (1, 0), (False, True), (torch.float32, torch.float64),
            ("full", "broadcast")):
        prm = dataclasses.replace(BASE, fix_vis=fix_vis, **case)
        t = lambda a: torch.as_tensor(a, dtype=dtype)
        cut = ((lambda a: a[..., :1].contiguous()) if geo == "broadcast"
               else (lambda a: a))
        args = (t(u), t(grad) if prm.viscous else None, cut(t(jg)), prm,
                cut(t(delta)), t(wdist), t(extra) if add else None)
        want = V.volume_tdisf_ref(*args)
        got = run_host(host_kernel, *args)
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        scale = max(want.abs().max().item(), 1.0)
        assert (got - want).abs().max().item() <= tol * scale, \
            (case, fix_vis, add, dtype, geo)
        n += 1
    assert n == len(CASES) * 16
