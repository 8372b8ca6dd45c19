"""K3: the element side of the LDG gradient path, by hand in CUDA C++.

``flux_point_qn`` computes, at every flux point of one block, the physical
gradient from the transformed gradient the opp_0 GEMM extrapolated there,
the element-side viscous (+ SGS, + added) flux and its projection qn on
the outward normal, which crosses the face instead of d gradient planes;
and the physical gradient itself where the block has boundary faces.
``solution_point_gradient`` computes the physical gradient at the solution
points from the transformed one (its face lift already added), in the
layout the volume kernel reads.  One launch each per block and stage
(csrc/ldg_element.cu, the per-point work in csrc/ldg_point.cuh; the flux
is volume_point.cuh's point_flux, the volume kernel's own).  The JAX
package's element side is jnp that XLA fuses (hifiles_tpu/solver/
residual_soa.py:1079-1085, :1153-1182); no TPU kernel stands behind it.

``flux_point_qn_ref`` and ``solution_point_gradient_ref`` are the same
algebra in torch ops: the CPU path and the reference the kernels are held
against.  For CUDA tensors the wrappers launch the kernels or raise.

Layouts (elements minor, as the residual's; E' = E or 1, one broadcast
column):
  flux points: tgf (d, F, E, Pf), u_f (F, E, Pf), jg adj(J)[m][l]
  (d, d, E', Pf), inv_det (E', Pf), norm (d, E', Pf), delta and wdist
  (E', Pf), extra (d, F, E, Pf) -> qn (F, E, Pf), grad (d, F, E, Pf);
  solution points: tg (d, U, F, E), jg adj(J)[m][l] (d, d, U, E'), inv_det
  (U, E') -> grad (d, U, F, E).
"""

from __future__ import annotations

import ctypes

import torch

from .volume import (SGS_NONE, SGS_SMAGORINSKY, VolumeParams, _Args,
                     _library, args_of, count_with, sgs_flux_p, sgs_kwargs,
                     variant, visc_flux_p, visc_kwargs)


class _FptsArgs(ctypes.Structure):
    """HftFptsArgs of csrc/ldg_point.cuh."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "tgf", "u", "jg", "inv_det", "norm", "delta", "wdist", "extra", "qn",
        "grad")] + [(n, ctypes.c_int32) for n in (
            "n_eles", "n_fpts", "jg_stride", "inv_det_stride", "norm_stride",
            "delta_stride", "wdist_stride")]


class _UptsArgs(ctypes.Structure):
    """HftUptsArgs of csrc/ldg_point.cuh."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "tg", "jg", "inv_det", "grad")] + [(n, ctypes.c_int32) for n in (
            "n_dims", "n_upts", "n_fields", "n_eles", "jg_stride",
            "inv_det_stride")]


def bind_entries(lib):
    """Set the argument types of K3's C entries (the CUDA library's, or a
    host build of the same interface) and return the library."""
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"hft_ldg_fpts_{dt}")
        # (args, physics, device, stream)
        fn.argtypes = [ctypes.POINTER(_FptsArgs), ctypes.POINTER(_Args),
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"hft_ldg_upts_{dt}")
        fn.argtypes = [ctypes.POINTER(_UptsArgs), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


_bound = False


def _lib(device):
    """The kernel library (volume._library), K3's entries bound."""
    global _bound
    lib = _library(device)
    if not _bound:
        bind_entries(lib)
        _bound = True
    return lib


# ----------------------------------------------------------------------
# the plain versions
# ----------------------------------------------------------------------

def flux_point_qn_ref(tgf, u_f, jg, inv_det, norm, prm: VolumeParams,
                      delta=None, wdist=None, extra=None, with_grad=False):
    """Plain torch version of flux_point_qn (same algebra, same layouts):
    (qn, the physical gradient or None)."""
    d, F = jg.shape[0], u_f.shape[0]
    g_f = [(sum(jg[m, l] * tgf[m] for m in range(d)) * inv_det)
           for l in range(d)]                              # d x (F, E, Pf)
    g_fp = [g.unbind(0) for g in g_f]
    u = u_f.unbind(0)
    fv = visc_flux_p(u, g_fp, d, **visc_kwargs(prm, F, d))
    adds = []
    if prm.sgs != SGS_NONE:
        adds.append(sgs_flux_p(u, g_fp, delta, wdist, d, **sgs_kwargs(prm)))
    if extra is not None:
        adds.append([x.unbind(0) for x in extra])
    for a in adds:
        fv = [[x + y for x, y in zip(ra, rb)] for ra, rb in zip(fv, a)]
    qn = torch.stack([sum(fv[m][i] * norm[m] for m in range(d))
                      for i in range(F)])                  # (F, E, Pf)
    return qn, torch.stack(g_f) if with_grad else None


def solution_point_gradient_ref(tg, jg, inv_det):
    """Plain torch version of solution_point_gradient."""
    d = jg.shape[0]
    return torch.stack([
        sum(jg[m, l][:, None] * tg[m] for m in range(d)) * inv_det[:, None]
        for l in range(d)])


# ----------------------------------------------------------------------
# the wrappers
# ----------------------------------------------------------------------

def _expect(name, t, shape, axis, E):
    """``t`` has ``shape``, its dimension ``axis`` E or 1."""
    ok = t is not None and t.dim() == len(shape) and all(
        n == want or (k == axis and n == 1)
        for k, (n, want) in enumerate(zip(t.shape, shape)))
    if not ok:
        raise ValueError(f"{name} must be {shape} (dimension {axis} {E} or "
                         f"1), got {None if t is None else tuple(t.shape)}")


def _same(ts, like):
    for t in ts:
        if t.device != like.device or t.dtype != like.dtype:
            raise ValueError("K3 operands must share device and dtype")
        if not t.is_contiguous():
            raise ValueError("K3 takes contiguous tensors")
    if like.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {like.dtype}")


def _stride(t, E):
    """A flux-point geometry operand's element stride: 1, or 0 for one
    column."""
    return int(t.shape[-2] == E and E > 1)


def _run(entry, *args):
    rc = entry(*args)
    if rc != 0:
        raise RuntimeError(f"K3 kernel launch failed: CUDA error {rc}")


def _count(fn, key):
    fn.launches += 1
    fn.by_variant[key] += 1


def check_fpts(tgf, u_f, jg, inv_det, norm, prm: VolumeParams, delta=None,
               wdist=None, extra=None):
    """flux_point_qn's operands checked: shapes, one device and dtype,
    contiguous, the viscous physics alone.  Returns (d, F, E, Pf)."""
    d = jg.shape[0] if jg.dim() == 4 else 0
    if d not in (2, 3) or u_f.dim() != 3 or \
            u_f.shape[0] not in (d + 2, d + 3):
        raise ValueError(f"u_f (F, E, Pf) with F = d + 2 or d + 3 and jg "
                         f"(d, d, E, Pf), got {tuple(u_f.shape)}, "
                         f"{tuple(jg.shape)}")
    if not prm.viscous or prm.inviscid:
        raise ValueError("flux_point_qn computes the viscous flux alone: "
                         "prm.viscous on, prm.inviscid off")
    F, E, Pf = u_f.shape
    _expect("tgf", tgf, (d, F, E, Pf), None, E)
    _expect("jg", jg, (d, d, E, Pf), 2, E)
    _expect("inv_det", inv_det, (E, Pf), 0, E)
    _expect("norm", norm, (d, E, Pf), 1, E)
    ts = [tgf, u_f, jg, inv_det, norm]
    if prm.sgs != SGS_NONE:
        _expect("delta", delta, (E, Pf), 0, E)
        _expect("wdist", wdist, (E, Pf), 0, E)
        ts += [delta, wdist]
    if extra is not None:
        _expect("extra", extra, (d, F, E, Pf), None, E)
        ts.append(extra)
    _same(ts, u_f)
    return d, F, E, Pf


def launch_fpts(entry, tgf, u_f, jg, inv_det, norm, prm: VolumeParams,
                delta, wdist, extra, qn, grad, device_index, stream):
    """One launch of ``entry`` (a flux-point C entry of K3's interface) on
    checked operands, writing ``qn`` and ``grad`` (None: not written);
    raises on an error code.  Delta is passed with an SGS model, wdist
    with Smagorinsky's (WALE's reads none)."""
    d, F = jg.shape[0], u_f.shape[0]
    _, E, Pf = u_f.shape
    sgs = prm.sgs != SGS_NONE
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _FptsArgs(
        tgf=ptr(tgf), u=ptr(u_f), jg=ptr(jg), inv_det=ptr(inv_det),
        norm=ptr(norm), delta=ptr(delta) if sgs else None,
        wdist=ptr(wdist) if prm.sgs == SGS_SMAGORINSKY else None,
        extra=ptr(extra), qn=ptr(qn), grad=ptr(grad), n_eles=E, n_fpts=Pf,
        jg_stride=_stride(jg, E), inv_det_stride=_stride(inv_det, E),
        norm_stride=_stride(norm, E),
        delta_stride=_stride(delta, E) if sgs else 0,
        wdist_stride=_stride(wdist, E) if sgs else 0)
    args = args_of(prm, F, d, extra is not None)
    _run(entry, ctypes.byref(a), ctypes.byref(args), device_index, stream)


def flux_point_qn(tgf, u_f, jg, inv_det, norm, prm: VolumeParams,
                  delta=None, wdist=None, extra=None, with_grad=False):
    """K3 at the flux points of one block: (qn (F, E, Pf), the physical
    gradient (d, F, E, Pf) when ``with_grad``, else None).  ``prm`` is the
    viscous physics with the inviscid part off (Physics.prm_visc); delta
    and wdist are read with an SGS model, ``extra`` is the added flux.
    The kernel for CUDA tensors, the plain version for CPU tensors.

    The counters sit on the function: ``launches``, and ``by_variant``
    by volume.variant's name; a launch recorded into a CUDA graph counts
    once per replay (volume.captured_launches, count_replay)."""
    d, F, _, _ = check_fpts(tgf, u_f, jg, inv_det, norm, prm, delta, wdist,
                            extra)
    dev = u_f.device
    if dev.type == "cpu":
        return flux_point_qn_ref(tgf, u_f, jg, inv_det, norm, prm, delta,
                                 wdist, extra, with_grad)
    if dev.type != "cuda":
        raise ValueError(f"flux_point_qn: unsupported device {dev}")
    lib = _lib(dev)
    qn = torch.empty_like(u_f)
    grad = torch.empty_like(tgf) if with_grad else None
    entry = (lib.hft_ldg_fpts_f32 if u_f.dtype == torch.float32
             else lib.hft_ldg_fpts_f64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the library's own CUDA runtime selects ``dev`` for the launch, which
    # makes it the thread's current card; the guard restores PyTorch's
    with torch.cuda.device(dev):
        launch_fpts(entry, tgf, u_f, jg, inv_det, norm, prm, delta, wdist,
                    extra, qn, grad, dev.index, stream)
    _count(flux_point_qn, variant(prm, F, extra is not None, d))
    return qn, grad


def check_upts(tg, jg, inv_det):
    """solution_point_gradient's operands checked; returns (d, U, F, E)."""
    d = jg.shape[0] if jg.dim() == 4 else 0
    if d not in (2, 3) or tg.dim() != 4 or tg.shape[0] != d:
        raise ValueError(f"tg (d, U, F, E) and jg (d, d, U, E) with d = 2 "
                         f"or 3, got {tuple(tg.shape)}, {tuple(jg.shape)}")
    _, U, F, E = tg.shape
    _expect("jg", jg, (d, d, U, E), 3, E)
    _expect("inv_det", inv_det, (U, E), 1, E)
    _same([tg, jg, inv_det], tg)
    return d, U, F, E


def launch_upts(entry, tg, jg, inv_det, grad, device_index, stream):
    """One launch of ``entry`` (a solution-point C entry of K3's
    interface) on checked operands, writing ``grad``; raises on an error
    code."""
    d, U, F, E = tg.shape
    col = lambda t: int(t.shape[-1] == E and E > 1)
    a = _UptsArgs(tg=tg.data_ptr(), jg=jg.data_ptr(),
                  inv_det=inv_det.data_ptr(), grad=grad.data_ptr(), n_dims=d,
                  n_upts=U, n_fields=F, n_eles=E, jg_stride=col(jg),
                  inv_det_stride=col(inv_det))
    _run(entry, ctypes.byref(a), device_index, stream)


def solution_point_gradient(tg, jg, inv_det):
    """K3 at the solution points of one block: the physical gradient
    (d, U, F, E) from the transformed gradient ``tg`` (d, U, F, E), adj(J)
    ``jg`` (d, d, U, E') and 1/det ``inv_det`` (U, E').  The kernel for
    CUDA tensors, the plain version for CPU tensors; counters as
    flux_point_qn's, by "D<d>F<F>"."""
    d, _, F, _ = check_upts(tg, jg, inv_det)
    dev = tg.device
    if dev.type == "cpu":
        return solution_point_gradient_ref(tg, jg, inv_det)
    if dev.type != "cuda":
        raise ValueError(f"solution_point_gradient: unsupported device "
                         f"{dev}")
    lib = _lib(dev)
    grad = torch.empty_like(tg)
    entry = (lib.hft_ldg_upts_f32 if tg.dtype == torch.float32
             else lib.hft_ldg_upts_f64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        launch_upts(entry, tg, jg, inv_det, grad, dev.index, stream)
    _count(solution_point_gradient, f"D{d}F{F}")
    return grad


count_with(flux_point_qn, solution_point_gradient)
