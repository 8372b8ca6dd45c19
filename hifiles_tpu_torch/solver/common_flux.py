"""K4: the interior common flux, by hand in CUDA C++.

``common_flux`` computes, at every point of every interior face, the
Riemann flux of the two sides' states (Rusanov, RoeM or HLLC by
riemann_solve_type; Lax-Friedrichs for advection-diffusion), adds the LDG
common viscous flux from the two sides' normal viscous fluxes qn (K3's),
and writes fn to the l side's flux-point slot and -fn to the r side's, in
one launch a stage and card (csrc/common_flux.cu, the per-point work in
csrc/face_point.cuh).  The JAX package's common flux is jnp that XLA fuses
(hifiles_tpu/solver/residual_soa.py:1185-1190 and its Riemann calls); no
TPU kernel stands behind it.

``common_flux_ref`` is the same work in torch ops, the plane functions of
residual_soa.py (riemann_of, ldg_sign_p) and the indexed stores of its
write-back: the CPU path and the reference the kernel is held against.
For CUDA tensors the wrapper launches the kernel or raises.

Layouts (faces minor, as the residual's face planes, FaceArrays): u_l,
u_r, qn_l, qn_r (F, R, C) or (F, C); the l side's unit normal norm
(d, R, C) or (d, R, 1); slot_l (R*C,) and slot_r (R*n_r,) int64, the
points' flux-point slots, slot_r for the first n_r columns only (a sharded
run's halo faces follow them, their r side on another shard) -> rows
(F, n_slots), every slot of the faces written, the others left as
torch.empty leaves them.
"""

from __future__ import annotations

import ctypes

import torch

from .residual import ResidualConfig
from .volume import _library, count_with


class _FaceArgs(ctypes.Structure):
    """HftFaceArgs of csrc/face_point.cuh."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "u_l", "u_r", "qn_l", "qn_r", "norm", "slot_l", "slot_r", "out")]
        + [(n, ctypes.c_int32) for n in (
            "n_rows", "n_cols", "n_r", "norm_cols")]
        + [("n_slots", ctypes.c_int64)])


class _FacePhysics(ctypes.Structure):
    """HftFacePhysics of csrc/face_point.cuh."""
    _fields_ = ([(n, ctypes.c_int32) for n in (
        "equation", "riemann", "n_dims", "n_fields", "viscous")]
        + [(n, ctypes.c_double) for n in (
            "gamma", "ldg_beta", "ldg_tau", "lambda_lf")]
        + [("wave_speed", ctypes.c_double * 3)])


ENTRIES = ("common_flux", "common_flux_naive")


def bind_entries(lib):
    """Set the argument types of K4's C entries (the CUDA library's, or a
    host build of the same interface) and return the library."""
    for name in ENTRIES:
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"hft_{name}_{dt}")
            # (args, physics, device, stream)
            fn.argtypes = [ctypes.POINTER(_FaceArgs),
                           ctypes.POINTER(_FacePhysics), ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


_bound = False


def _lib(device):
    """The kernel library (volume._library), K4's entries bound."""
    global _bound
    lib = _library(device)
    if not _bound:
        bind_entries(lib)
        _bound = True
    return lib


SOLVERS = {0: "rusanov", 2: "roem", 3: "hllc"}


def variant(cfg: ResidualConfig, n_fields: int, n_dims: int) -> str:
    """Name of what one launch computes, e.g. "D3F5+hllc+ldg"."""
    solver = ("lf" if cfg.equation == 1
              else SOLVERS[cfg.riemann_solve_type])
    return f"D{n_dims}F{n_fields}+{solver}" + ("+ldg" if cfg.viscous else "")


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------

def common_flux_ref(u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r, n_slots,
                    cfg: ResidualConfig):
    """Plain torch version of common_flux (same algebra, same layouts)."""
    # residual_soa imports this module
    from .residual_soa import ldg_sign_p, riemann_of
    d, F = norm.shape[0], u_l.shape[0]
    nrm = list(norm.unbind(0))
    fn = torch.stack(riemann_of(cfg, d)(u_l.unbind(0), u_r.unbind(0), nrm,
                                        cfg.gamma, d))
    if cfg.viscous:
        # LDG common viscous flux (ref:src/inters.cpp:561-611); the r side
        # enters with a sign flip, n_r = -n_l
        sgn = ldg_sign_p(nrm)
        bl = 0.5 + cfg.ldg_beta * sgn
        br = 0.5 - cfg.ldg_beta * sgn
        fn = fn + bl * qn_l - br * qn_r - cfg.ldg_tau * (u_r - u_l)
    # the write-back (ref:src/int_inters.cpp:217-220 writes point by
    # point); a halo face's r side lives on another shard
    n_r = slot_r.numel() // _rows(u_l)
    out = torch.empty((F, n_slots), dtype=fn.dtype, device=fn.device)
    out.index_copy_(1, slot_l, fn.reshape(F, -1))
    out.index_copy_(1, slot_r, -fn[..., :n_r].reshape(F, -1))
    return out


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------

def _rows(u):
    """The rows R of (F, R, C) face planes; 1 for flat (F, C) planes."""
    return u.shape[1] if u.dim() == 3 else 1


def check(u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r, n_slots,
          cfg: ResidualConfig):
    """common_flux's operands checked: shapes, one device and dtype,
    contiguous, the physics K4 computes.  Returns (d, F, R, C, n_r)."""
    if u_l.dim() not in (2, 3):
        raise ValueError(f"u_l must be (F, R, C) or (F, C), got "
                         f"{tuple(u_l.shape)}")
    F, R, C = u_l.shape[0], _rows(u_l), u_l.shape[-1]
    d = norm.shape[0] if norm.dim() == u_l.dim() else 0
    if d not in (2, 3):
        raise ValueError(f"norm must be (d, *{tuple(u_l.shape[1:])}) with "
                         f"d = 2 or 3, got {tuple(norm.shape)}")
    if cfg.equation == 1:
        fields = (1,)
    elif cfg.riemann_solve_type == 3:
        fields = (d + 2,)
    else:
        fields = (d + 2, d + 3)
    if cfg.equation not in (0, 1) or F not in fields or (
            cfg.equation == 0 and cfg.riemann_solve_type not in SOLVERS):
        raise ValueError(f"K4 computes equation 0 with Rusanov or RoeM (F = "
                         f"d + 2 or d + 3) or HLLC (F = d + 2), or equation "
                         f"1 (F = 1): got equation {cfg.equation}, "
                         f"riemann_solve_type {cfg.riemann_solve_type}, "
                         f"F = {F}, d = {d}")
    planes = [("u_r", u_r)] + ([("qn_l", qn_l), ("qn_r", qn_r)]
                               if cfg.viscous else [])
    for name, t in planes:
        if t is None or t.shape != u_l.shape:
            raise ValueError(f"{name} must be {tuple(u_l.shape)} like u_l, "
                             f"got {None if t is None else tuple(t.shape)}")
    if tuple(norm.shape[1:]) not in (tuple(u_l.shape[1:]),
                                     tuple(u_l.shape[1:-1]) + (1,)):
        raise ValueError(f"norm must be (d, {tuple(u_l.shape[1:])}) or one "
                         f"column, got {tuple(norm.shape)}")
    if slot_l.dim() != 1 or slot_l.numel() != R * C or slot_r.dim() != 1 \
            or slot_r.numel() % R or slot_r.numel() > R * C:
        raise ValueError(f"slot_l must be ({R * C},) and slot_r (R * n_r,) "
                         f"with n_r <= {C}, got {tuple(slot_l.shape)}, "
                         f"{tuple(slot_r.shape)}")
    ts = [u_l, norm] + [t for _, t in planes]
    for t in ts:
        if t.device != u_l.device or t.dtype != u_l.dtype:
            raise ValueError("K4 operands must share device and dtype")
        if not t.is_contiguous():
            raise ValueError("K4 takes contiguous tensors")
    for t in (slot_l, slot_r):
        if t.device != u_l.device or t.dtype != torch.int64 or \
                not t.is_contiguous():
            raise ValueError("K4's slots are contiguous int64 on the "
                             "planes' device")
    if u_l.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {u_l.dtype}")
    return d, F, R, C, slot_r.numel() // R


def physics_of(cfg: ResidualConfig, d, F) -> _FacePhysics:
    """K4's physics struct for ``cfg`` at (d, F)."""
    ws = [float(cfg.wave_speed[m]) if m < len(cfg.wave_speed) else 0.0
          for m in range(3)]
    return _FacePhysics(
        equation=cfg.equation, riemann=cfg.riemann_solve_type, n_dims=d,
        n_fields=F, viscous=int(bool(cfg.viscous)), gamma=cfg.gamma,
        ldg_beta=cfg.ldg_beta, ldg_tau=cfg.ldg_tau, lambda_lf=cfg.lambda_lf,
        wave_speed=(ctypes.c_double * 3)(*ws))


def launch(entry, u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r, n_slots,
           cfg: ResidualConfig, out, device_index, stream):
    """One launch of ``entry`` (a C entry of K4's interface) on checked
    operands, writing ``out`` (F, n_slots); raises on an error code."""
    F, R, C = u_l.shape[0], _rows(u_l), u_l.shape[-1]
    d = norm.shape[0]
    ptr = lambda t: None if t is None else t.data_ptr()
    visc = bool(cfg.viscous)
    a = _FaceArgs(
        u_l=ptr(u_l), u_r=ptr(u_r), qn_l=ptr(qn_l) if visc else None,
        qn_r=ptr(qn_r) if visc else None, norm=ptr(norm),
        slot_l=ptr(slot_l), slot_r=ptr(slot_r), out=ptr(out), n_rows=R,
        n_cols=C, n_r=slot_r.numel() // max(R, 1),
        norm_cols=norm.shape[-1], n_slots=n_slots)
    phys = physics_of(cfg, d, F)
    rc = entry(ctypes.byref(a), ctypes.byref(phys), device_index, stream)
    if rc != 0:
        raise RuntimeError(f"K4 kernel launch failed: CUDA error {rc}")


def common_flux(u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r, n_slots,
                cfg: ResidualConfig):
    """K4 over the interior faces: the flux-point rows (F, n_slots) with
    the common flux fn at ``slot_l`` and -fn at ``slot_r`` (first n_r
    columns), the other slots unset.  ``cfg`` gives the equation, the
    Riemann solver, gamma and the LDG parameters; qn_l and qn_r are read
    when cfg.viscous.  The kernel for CUDA tensors, the plain version for
    CPU tensors.

    The counters sit on the function: ``launches``, and ``by_variant`` by
    variant's name; a launch recorded into a CUDA graph counts once per
    replay (volume.captured_launches, count_replay)."""
    d, F, _, _, _ = check(u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r,
                          n_slots, cfg)
    dev = u_l.device
    if dev.type == "cpu":
        return common_flux_ref(u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r,
                               n_slots, cfg)
    if dev.type != "cuda":
        raise ValueError(f"common_flux: unsupported device {dev}")
    lib = _lib(dev)
    out = torch.empty((F, n_slots), dtype=u_l.dtype, device=dev)
    entry = (lib.hft_common_flux_f32 if u_l.dtype == torch.float32
             else lib.hft_common_flux_f64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the library's own CUDA runtime selects ``dev`` for the launch, which
    # makes it the thread's current card; the guard restores PyTorch's
    with torch.cuda.device(dev):
        launch(entry, u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r, n_slots,
               cfg, out, dev.index, stream)
    common_flux.launches += 1
    common_flux.by_variant[variant(cfg, F, d)] += 1
    return out


count_with(common_flux)
