"""Volume stage of the FR residual: fluxes + adjugate transform per point.

``volume_tdisf_many`` is the port of the JAX package's one Pallas kernel,
hifiles_tpu/solver/pallas_kernels.py::volume_tdisf_fm, written by hand in
CUDA C++ (csrc/volume_tdisf.cu, the per-point work in
csrc/volume_point.cuh) and extended to the volume stage of every
configuration the port runs (residual_soa.py:1094-1139 of the JAX
package) at d = 2 and d = 3: SA-RANS (F = d + 3), Sutherland viscosity,
the eddy-viscosity SGS flux (Smagorinsky or WALE), an added physical flux
(the similarity SGS flux), and the inviscid part on or off (the
over-integration path launches it once at the cubature points, inviscid
only, and once at the solution points, viscous only).  One launch takes
the blocks of several element types and shards of one variant on one
card (up to MAX_SEGMENTS); ``volume_tdisf`` is the one-block case and
``volume_tdisf_groups`` gathers the volume requests of several shards'
residuals by device and variant.
``volume_tdisf_ref`` is the same algebra in torch ops, composed from the
plane functions below: the CPU path and the reference the kernel is held
against.

Layouts (elements minor, as the residual's state):
  u (U, F, E), grad (d, U, F, E), jg (d, d, U, E'), delta and wdist
  (U, E'), extra (d, U, F, E), with E' = E or 1 (one broadcast column)
  -> tdisf (d, U, F, E),  tdisf[l][:, i] = sum_m jg[l][m] * f_i,m.
The dimension d of a launch is read from jg.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import List, NamedTuple, Optional

import torch

from .. import backend

SGS_NONE, SGS_SMAGORINSKY, SGS_WALE = -1, 0, 1


@dataclasses.dataclass(frozen=True)
class VolumeParams:
    """What the volume stage computes, fixed for a residual.  ``mu`` is
    mu_inf; ``fix_vis`` 0 is Sutherland's law; ``sgs`` is SGS_NONE,
    SGS_SMAGORINSKY or SGS_WALE; F = d + 3 (the SA field) turns the SA
    terms on."""
    gamma: float = 1.4
    prandtl: float = 0.72
    mu: float = 0.0
    viscous: bool = False
    inviscid: bool = True
    fix_vis: int = 1
    rt_inf: float = 1.0
    c_sth: float = 0.0
    prandtl_t: float = 0.9
    c_v1: float = 7.1
    omega: float = 2.0 / 3.0
    sgs: int = SGS_NONE
    C_s: float = 0.0
    kappa: float = 0.41


# ----------------------------------------------------------------------
# plane physics (fields as lists of (..., E) planes), ported from
# hifiles_tpu/solver/residual_soa.py
# ----------------------------------------------------------------------

def softplus(x):
    """log(1 + exp(x)) without overflow, as jax.nn.softplus computes it
    (torch.nn.functional.softplus returns x above its threshold 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def inv_flux_p(u, d, gamma):
    """Inviscid flux planes [d][F] (residual_soa.py:956-980 of the JAX
    package), the SA field advecting passively."""
    rho = u[0]
    inv_rho = 1.0 / rho
    v = [u[1 + m] * inv_rho for m in range(d)]
    q2 = sum(vi * vi for vi in v)
    p = (gamma - 1.0) * (u[d + 1] - 0.5 * rho * q2)
    hp = u[d + 1] + p
    out = []
    for mm in range(d):
        rows = [u[1 + mm]]
        for i in range(d):
            r = u[1 + i] * v[mm]
            if i == mm:
                r = r + p
            rows.append(r)
        rows.append(hp * v[mm])
        for k in range(d + 2, len(u)):    # SA advection
            rows.append(u[k] * v[mm])
        out.append(rows)
    return out


def sutherland_mu_p(inte, gamma, mu_inf, rt_inf, c_sth, fix_vis):
    """Dynamic viscosity from the internal-energy plane
    (ref:src/flux.cpp:172-174): mu_inf (a float) when fix_vis, else
    Sutherland's law."""
    if fix_vis:
        return mu_inf
    rt_ratio = (gamma - 1.0) * inte / rt_inf
    return mu_inf * rt_ratio**1.5 * (1.0 + c_sth) / (rt_ratio + c_sth)


def visc_flux_p(u, gr, d, *, gamma, prandtl, mu_inf, rt_inf, c_sth, fix_vis,
                rans=False, prandtl_t=0.9, c_v1=7.1, omega=2.0 / 3.0):
    """Viscous flux planes: u F-list, gr [d][F]-list -> [d][F]-list
    (ref:src/flux.cpp:127-325; SA diffusion ref:src/flux.cpp:225-241);
    fix_vis 0 is Sutherland's law."""
    rho = u[0]
    inv_rho = 1.0 / rho
    v = [u[1 + m] * inv_rho for m in range(d)]
    q2 = sum(vi * vi for vi in v)
    inte = u[d + 1] * inv_rho - 0.5 * q2
    mu = sutherland_mu_p(inte, gamma, mu_inf, rt_inf, c_sth, fix_vis)
    if rans:
        nu_tilde_c = u[d + 2]
        chi = nu_tilde_c / mu
        f_v1 = chi**3 / (chi**3 + c_v1**3)
        mu_t = torch.where(nu_tilde_c >= 0.0, nu_tilde_c * f_v1,
                           torch.zeros_like(nu_tilde_c))
        mu_tot = mu + mu_t
        kth = (mu / prandtl + mu_t / prandtl_t) * gamma
    else:
        mu_tot = mu
        kth = mu * gamma / prandtl
    dv = [[(gr[l][1 + i] - v[i] * gr[l][0]) * inv_rho for l in range(d)]
          for i in range(d)]
    dint = [(gr[l][d + 1] - (0.5 * q2 + inte) * gr[l][0]) * inv_rho
            - sum(v[i] * dv[i][l] for i in range(d)) for l in range(d)]
    div = sum(dv[i][i] for i in range(d))
    tau = [[mu_tot * (dv[i][l] + dv[l][i]) for l in range(d)]
           for i in range(d)]
    for i in range(d):
        tau[i][i] = tau[i][i] - 2.0 / 3.0 * mu_tot * div
    out = []
    for mm in range(d):
        rows = [torch.zeros_like(rho)]
        for i in range(d):
            rows.append(-tau[i][mm])
        rows.append(-(sum(v[i] * tau[i][mm] for i in range(d))
                      + kth * dint[mm]))
        out.append(rows)
    if rans:
        nu_tilde = nu_tilde_c * inv_rho
        psi = torch.where(chi <= 10.0, 0.05 * softplus(20.0 * chi), chi)
        coef = (1.0 / omega) * mu * (1.0 + psi)
        for mm in range(d):
            dnu = (gr[mm][d + 2] - gr[mm][0] * nu_tilde) * inv_rho
            out[mm].append(-coef * dnu)
    return out


def sgs_flux_p(u, gr, delta, wdist, d, *, sgs_model, C_s, gamma, prandtl_t,
               kappa):
    """Eddy-viscosity SGS flux planes (ref:src/eles.cpp:2470-2612):
    sgs_model 0 is Smagorinsky with wall limiting, any other WALE.
    ``delta`` already includes the filter-ratio factor.  Returns [d][F],
    added to the viscous flux."""
    F = len(u)
    rho = u[0]
    inv_rho = 1.0 / rho
    v = [u[1 + m] * inv_rho for m in range(d)]
    q2 = sum(vi * vi for vi in v)
    inte = u[d + 1] * inv_rho - 0.5 * q2
    dv = [[(gr[l][1 + i] - v[i] * gr[l][0]) * inv_rho for l in range(d)]
          for i in range(d)]
    dke = [0.5 * q2 * gr[l][0]
           + rho * sum(v[i] * dv[i][l] for i in range(d)) for l in range(d)]
    de = [(gr[l][d + 1] - dke[l] - gr[l][0] * inte) * inv_rho
          for l in range(d)]
    S = [[0.5 * (dv[i][l] + dv[l][i]) for l in range(d)] for i in range(d)]

    if sgs_model == 0:
        # Smagorinsky with wall limiting (ref:src/eles.cpp:2470-2546)
        Smod = torch.sqrt(2.0 * sum(S[i][l] * S[i][l]
                                    for i in range(d) for l in range(d)))
        lim = torch.minimum(wdist * wdist * kappa**2,
                            C_s**2 * delta * delta)
        mu_t = rho * lim * Smod
    else:
        # WALE (ref:src/eles.cpp:2548-2592)
        eps = 1e-12
        g2 = [[sum(dv[i][k] * dv[k][l] for k in range(d)) for l in range(d)]
              for i in range(d)]
        trace3 = sum(g2[i][i] for i in range(d)) / 3.0
        Sq = [[0.5 * (g2[i][l] + g2[l][i]) - (trace3 if i == l else 0.0)
               for l in range(d)] for i in range(d)]
        num = sum(Sq[i][l] * Sq[i][l] for i in range(d) for l in range(d))
        den = sum(S[i][l] * S[i][l] for i in range(d) for l in range(d))
        den = den**2.5 + num**1.25
        mu_t = rho * C_s**2 * delta * delta * num**1.5 / (den + eps)

    trS3 = sum(S[i][i] for i in range(d)) / 3.0
    mom = [[-2.0 * mu_t * (S[i][l] - (trS3 if i == l else 0.0))
            for l in range(d)] for i in range(d)]
    coef = gamma * mu_t / prandtl_t
    out = []
    zero = torch.zeros_like(rho)
    for mm in range(d):
        rows = [zero]
        for i in range(d):
            rows.append(mom[i][mm])
        rows.append(-coef * de[mm]
                    + sum(v[k] * mom[k][mm] for k in range(d)))
        while len(rows) < F:
            rows.append(zero)
        out.append(rows)
    return out


def visc_kwargs(prm: VolumeParams, n_fields: int, d: int) -> dict:
    """visc_flux_p keywords of a VolumeParams at dimension d."""
    return dict(gamma=prm.gamma, prandtl=prm.prandtl, mu_inf=prm.mu,
                rt_inf=prm.rt_inf, c_sth=prm.c_sth, fix_vis=prm.fix_vis,
                rans=n_fields == d + 3, prandtl_t=prm.prandtl_t,
                c_v1=prm.c_v1, omega=prm.omega)


def sgs_kwargs(prm: VolumeParams) -> dict:
    """sgs_flux_p keywords of a VolumeParams with an SGS model."""
    return dict(sgs_model=prm.sgs, C_s=prm.C_s, gamma=prm.gamma,
                prandtl_t=prm.prandtl_t, kappa=prm.kappa)


# ----------------------------------------------------------------------
# the volume stage
# ----------------------------------------------------------------------

def volume_tdisf_ref(u, grad, jg, prm: VolumeParams, delta=None, wdist=None,
                     extra=None):
    """Plain torch version of the volume kernel (same algebra, same
    layouts).  ``grad`` is read only when ``prm.viscous``, ``delta`` and
    ``wdist`` only with an SGS model; ``extra`` is added to the physical
    flux before the transform."""
    F = u.shape[1]
    D = jg.shape[0]
    up = list(u.unbind(1))
    zero = torch.zeros_like(up[0])
    fl = (inv_flux_p(up, D, prm.gamma) if prm.inviscid
          else [[zero] * F for _ in range(D)])
    if prm.viscous:
        gr = [list(g.unbind(1)) for g in grad.unbind(0)]
        fv = visc_flux_p(up, gr, D, **visc_kwargs(prm, F, D))
        if prm.sgs != SGS_NONE:
            fs = sgs_flux_p(up, gr, delta, wdist, D, **sgs_kwargs(prm))
            fv = [[a + b for a, b in zip(fv[m], fs[m])] for m in range(D)]
        fl = [[a + b for a, b in zip(fl[m], fv[m])] for m in range(D)]
    if extra is not None:
        fl = [[a + b for a, b in zip(fl[m], extra[m].unbind(1))]
              for m in range(D)]

    def transform(l, i):
        acc = jg[l, 0] * fl[0][i]
        for m in range(1, D):
            acc = acc + jg[l, m] * fl[m][i]
        return acc
    return torch.stack([torch.stack([transform(l, i) for i in range(F)],
                                    dim=1) for l in range(D)])


def _check(u, grad, jg, prm, delta, wdist, extra):
    D = jg.shape[0] if jg.dim() == 4 else 0
    if D not in (2, 3):
        raise ValueError(f"jg must be (d, d, U, E) with d = 2 or 3, got "
                         f"{tuple(jg.shape)}")
    if u.dim() != 3 or u.shape[1] not in (D + 2, D + 3):
        raise ValueError(f"u must be (U, {D + 2} or {D + 3}, E) at d = {D}, "
                         f"got {tuple(u.shape)}")
    U, F, E = u.shape

    def plane(name, t, shape):
        if t.dim() != len(shape) or t.shape[:-1] != shape[:-1] \
                or t.shape[-1] not in (1, E):
            raise ValueError(f"{name} must be {shape[:-1] + (E,)} or with "
                             f"a last axis of 1, got {tuple(t.shape)}")

    plane("jg", jg, (D, D, U, E))
    ts = [u, jg]
    if prm.viscous:
        if grad is None or tuple(grad.shape) != (D, U, F, E):
            raise ValueError(f"grad must be ({D}, {U}, {F}, {E}), got "
                             f"{None if grad is None else tuple(grad.shape)}")
        ts.append(grad)
        if prm.sgs != SGS_NONE:
            if delta is None or wdist is None:
                raise ValueError("an SGS model needs delta and wdist")
            plane("delta", delta, (U, E))
            plane("wdist", wdist, (U, E))
            ts += [delta, wdist]
    if prm.sgs not in (SGS_NONE, SGS_SMAGORINSKY, SGS_WALE):
        raise ValueError(f"unknown sgs {prm.sgs}")
    if extra is not None:
        if tuple(extra.shape) != (D, U, F, E):
            raise ValueError(f"extra must be ({D}, {U}, {F}, {E}), "
                             f"got {tuple(extra.shape)}")
        ts.append(extra)
    for t in ts:
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError("volume_tdisf operands must share device and "
                             "dtype")
        if not t.is_contiguous():
            raise ValueError("volume_tdisf takes contiguous tensors")
    if u.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {u.dtype}")


MAX_SEGMENTS = 16       # kMaxSegments of csrc/volume_point.cuh


class VolumeCall(NamedTuple):
    """The operands of one block's volume stage (as volume_tdisf_ref's)."""
    u: torch.Tensor
    grad: Optional[torch.Tensor]
    jg: torch.Tensor
    delta: Optional[torch.Tensor] = None
    wdist: Optional[torch.Tensor] = None
    extra: Optional[torch.Tensor] = None


@dataclasses.dataclass
class VolumeRequest:
    """What a residual's stage generator yields at its volume stage: its
    blocks' calls, all of one VolumeParams; it takes back their outputs
    in the same order."""
    calls: List[VolumeCall]
    prm: VolumeParams


class _Args(ctypes.Structure):
    """HftVolumeArgs of csrc/volume_point.cuh: the physics of one launch."""
    _fields_ = [(n, ctypes.c_int32) for n in ("n_fields", "n_dims")] + [
        (n, ctypes.c_double) for n in (
            "gamma", "prandtl", "prandtl_t", "mu_inf", "rt_inf", "c_sth",
            "c_v1", "omega", "C_s", "kappa")] + [
        (n, ctypes.c_int32) for n in (
            "viscous", "inviscid", "sutherland", "sgs", "has_extra")]


class _Segment(ctypes.Structure):
    """HftVolumeSegment of csrc/volume_point.cuh: one block of a launch
    (the library numbers its tiles)."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "u", "grad", "jg", "delta", "wdist", "extra", "out")] + [
        (n, ctypes.c_int32) for n in (
            "n_upts", "n_eles", "jg_stride", "delta_stride", "wdist_stride",
            "first_tile", "tiles_per_row", "bulk")]


def bind_entries(lib):
    """Set the argument types of the library's C entries (the CUDA one, or
    a host build of the same interface) and return it."""
    for name in ("hft_volume_tdisf_f32", "hft_volume_tdisf_f64"):
        fn = getattr(lib, name)
        # (segments, n_segments, args, device, stream)
        fn.argtypes = [ctypes.POINTER(_Segment), ctypes.c_int,
                       ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


_prepared = set()


def _library(device):
    """The kernel library, prepared for ``device`` (its shared-memory
    limits and occupancy set once, at its first launch there)."""
    lib = backend.kernel_library()
    if device.index not in _prepared:
        bind_entries(lib)
        lib.hft_volume_prepare.argtypes = [ctypes.c_int]
        lib.hft_volume_prepare.restype = ctypes.c_int
        with torch.cuda.device(device):
            rc = lib.hft_volume_prepare(device.index)
        if rc != 0:
            raise RuntimeError(f"volume_tdisf: preparing the kernels on "
                               f"{device} failed: CUDA error {rc}")
        _prepared.add(device.index)
    return lib


def variant(prm: VolumeParams, n_fields: int, has_extra: bool,
            n_dims: int) -> str:
    """Name of what one launch computes, e.g. "D3F6+inviscid+viscous" or
    "D2F4+viscous+wale+added-flux"."""
    parts = [f"D{n_dims}F{n_fields}"]
    if prm.inviscid:
        parts.append("inviscid")
    if prm.viscous:
        parts.append("viscous" if prm.fix_vis else "sutherland")
        if prm.sgs != SGS_NONE:
            parts.append("smagorinsky" if prm.sgs == SGS_SMAGORINSKY
                         else "wale")
    if has_extra:
        parts.append("added-flux")
    return "+".join(parts)


def call_variant(call: VolumeCall, prm: VolumeParams) -> str:
    return variant(prm, call.u.shape[1], call.extra is not None,
                   call.jg.shape[0])


def _check_group(calls, prm):
    """Each call as volume_tdisf checks it, and all of one launch: one
    device, dtype and variant (d, F, the added flux)."""
    if not calls:
        raise ValueError("volume_tdisf_many: no calls")
    for c in calls:
        _check(c.u, c.grad, c.jg, prm, c.delta, c.wdist, c.extra)
    first = calls[0]
    key = call_variant(first, prm)
    for c in calls[1:]:
        if c.u.device != first.u.device or c.u.dtype != first.u.dtype:
            raise ValueError("volume_tdisf_many: calls on different devices "
                             "or dtypes")
        if call_variant(c, prm) != key:
            raise ValueError(f"volume_tdisf_many: calls of different "
                             f"variants ({key}, {call_variant(c, prm)})")


def args_of(prm: VolumeParams, n_fields, n_dims, has_extra) -> _Args:
    return _Args(
        n_fields=n_fields, n_dims=n_dims, gamma=prm.gamma,
        prandtl=prm.prandtl, prandtl_t=prm.prandtl_t, mu_inf=prm.mu,
        rt_inf=prm.rt_inf, c_sth=prm.c_sth, c_v1=prm.c_v1, omega=prm.omega,
        C_s=prm.C_s, kappa=prm.kappa, viscous=int(bool(prm.viscous)),
        inviscid=int(bool(prm.inviscid)), sutherland=int(not prm.fix_vis),
        sgs=prm.sgs if prm.viscous else SGS_NONE,
        has_extra=int(has_extra))


def segments_of(calls, prm: VolumeParams, outs):
    """The segment table of one launch: each call's pointers (grad only
    when viscous, delta and wdist only with an SGS model), U, E and the
    element strides (0 for a broadcast column)."""
    sgs = prm.viscous and prm.sgs != SGS_NONE
    table = (_Segment * len(calls))()
    for seg, c, out in zip(table, calls, outs):
        U, _, E = c.u.shape
        stride = lambda t: int(t is not None and t.shape[-1] == E and E > 1)
        ptr = lambda t: None if t is None else t.data_ptr()
        seg.u, seg.jg, seg.extra, seg.out = (ptr(c.u), ptr(c.jg),
                                             ptr(c.extra), ptr(out))
        seg.grad = ptr(c.grad) if prm.viscous else None
        seg.delta = ptr(c.delta) if sgs else None
        seg.wdist = ptr(c.wdist) if sgs else None
        seg.n_upts, seg.n_eles = U, E
        seg.jg_stride = stride(c.jg)
        seg.delta_stride = stride(c.delta) if sgs else 0
        seg.wdist_stride = stride(c.wdist) if sgs else 0
    return table


def launch_segments(entry, calls, prm: VolumeParams, outs, device_index,
                    stream):
    """Launches of ``entry`` (a C entry of the library's interface) over
    ``calls``, MAX_SEGMENTS at a time, writing ``outs``, each counted on
    volume_tdisf's counters; raises on an error code.  Returns the calls
    of each launch."""
    c = calls[0]
    args = args_of(prm, c.u.shape[1], c.jg.shape[0], c.extra is not None)
    key = call_variant(c, prm)
    f = volume_tdisf
    parts = []
    for a in range(0, len(calls), MAX_SEGMENTS):
        part = calls[a:a + MAX_SEGMENTS]
        table = segments_of(part, prm, outs[a:a + MAX_SEGMENTS])
        rc = entry(table, len(part), ctypes.byref(args), device_index,
                   stream)
        if rc != 0:
            raise RuntimeError(f"volume_tdisf kernel launch failed: CUDA "
                               f"error {rc}")
        shapes = [(x.u.shape[0], x.u.shape[2]) for x in part]
        f.launches += 1
        f.segments += len(part)
        f.by_variant[key] += 1
        f.by_shape.update((key, U, E) for U, E in shapes)
        f.by_group[(key, tuple(sorted(shapes)))] += 1
        parts.append(part)
    return parts


def volume_tdisf_many_ref(calls, prm: VolumeParams):
    """Plain version of volume_tdisf_many: volume_tdisf_ref per call."""
    return [volume_tdisf_ref(c.u, c.grad, c.jg, prm, c.delta, c.wdist,
                             c.extra) for c in calls]


def volume_tdisf_many(calls, prm: VolumeParams):
    """The volume stage of several blocks (VolumeCall each) of one variant
    on one device: one kernel launch for up to MAX_SEGMENTS of them, the
    plain version for CPU tensors.  Returns their outputs in order.
    Raises on calls of different devices, dtypes or variants.

    The counters sit on ``volume_tdisf``: ``launches`` and ``by_variant``
    count launches, ``segments`` and ``by_shape`` (variant, U, E) the
    blocks they carried, ``by_group`` (variant, sorted (U, E) of its
    segments) the launches by their table (CPU calls do not count).  A
    launch recorded into a CUDA graph counts once per replay of the graph
    (``captured_launches``, ``count_replay``)."""
    calls = [VolumeCall(*c) for c in calls]
    _check_group(calls, prm)
    dev = calls[0].u.device
    if dev.type == "cpu":
        return volume_tdisf_many_ref(calls, prm)
    if dev.type != "cuda":
        raise ValueError(f"volume_tdisf: unsupported device {dev}")
    lib = _library(dev)
    entry = (lib.hft_volume_tdisf_f32 if calls[0].u.dtype == torch.float32
             else lib.hft_volume_tdisf_f64)
    D = calls[0].jg.shape[0]
    outs = [torch.empty((D,) + tuple(c.u.shape), device=dev,
                        dtype=c.u.dtype) for c in calls]
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the library's own CUDA runtime selects ``dev`` for the launch, which
    # makes it the thread's current card; the guard restores PyTorch's
    with torch.cuda.device(dev):
        launch_segments(entry, calls, prm, outs, dev.index, stream)
    return outs


def volume_tdisf(u, grad, jg, prm: VolumeParams, delta=None, wdist=None,
                 extra=None):
    """Volume stage of one block: volume_tdisf_many of one call (the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors; arguments
    as volume_tdisf_ref).  Holds the kernel's counters (see
    volume_tdisf_many)."""
    return volume_tdisf_many(
        [VolumeCall(u, grad, jg, delta, wdist, extra)], prm)[0]


def volume_tdisf_groups(requests):
    """The VolumeRequests of several residuals (the shards of a run) ->
    each one's outputs: their calls gathered by device and variant, one
    volume_tdisf_many per group."""
    groups = collections.defaultdict(list)
    for r, req in enumerate(requests):
        for i, c in enumerate(req.calls):
            key = (c.u.device, c.u.dtype, req.prm, call_variant(c, req.prm))
            groups[key].append((r, i, c))
    outs = [[None] * len(req.calls) for req in requests]
    for (_, _, prm, _), members in groups.items():
        got = volume_tdisf_many([c for _, _, c in members], prm)
        for (r, i, _), t in zip(members, got):
            outs[r][i] = t
    return outs


COUNTERS = ("launches", "segments", "by_variant", "by_shape", "by_group")
# the other hand kernels' wrappers (count_with), each with the counters
# ``launches`` and ``by_variant``
OTHER_COUNTED = []


def _zero(f):
    f.launches = 0
    f.by_variant = collections.Counter()


def reset_counters():
    """Set every counter of the volume kernel and of the OTHER_COUNTED
    wrappers to 0."""
    f = volume_tdisf
    _zero(f)
    f.segments = 0
    f.by_shape = collections.Counter()
    f.by_group = collections.Counter()
    for g in OTHER_COUNTED:
        _zero(g)


def count_with(*fns):
    """Give the wrappers ``fns`` of other hand kernels the counters
    ``launches`` and ``by_variant``, at 0, which reset_counters,
    captured_launches and count_replay then carry with the volume
    kernel's."""
    for g in fns:
        _zero(g)
        OTHER_COUNTED.append(g)


reset_counters()


def _counters():
    f = volume_tdisf
    return (f.launches, f.segments, collections.Counter(f.by_variant),
            collections.Counter(f.by_shape), collections.Counter(f.by_group),
            [(g.launches, collections.Counter(g.by_variant))
             for g in OTHER_COUNTED])


def captured_launches(capture):
    """Run ``capture()``, which records a step's launches into a CUDA graph
    without running them, and return the counters' increase over it
    (launches, segments, by_variant, by_shape, by_group, and (launches,
    by_variant) of each OTHER_COUNTED wrapper): the launches of one
    replay.  The counters go back to what they were, since nothing ran."""
    f = volume_tdisf
    before = _counters()
    capture()
    now = _counters()
    delta = (now[0] - before[0], now[1] - before[1]) + tuple(
        b - a for a, b in zip(before[2:5], now[2:5])) + (
        [(b[0] - a[0], b[1] - a[1]) for a, b in zip(before[5], now[5])],)
    f.launches, f.segments = before[:2]
    for name, was in zip(COUNTERS[2:], before[2:5]):
        getattr(f, name).clear()
        getattr(f, name).update(was)
    for g, (n, was) in zip(OTHER_COUNTED, before[5]):
        g.launches = n
        g.by_variant.clear()
        g.by_variant.update(was)
    return delta


def count_replay(delta):
    """Add one replay's launches ``delta`` (captured_launches) to the
    counters: the replay launched them, though no host call did."""
    f = volume_tdisf
    f.launches += delta[0]
    f.segments += delta[1]
    for name, d in zip(COUNTERS[2:], delta[2:5]):
        getattr(f, name).update(d)
    for g, (n, by) in zip(OTHER_COUNTED, delta[5]):
        g.launches += n
        g.by_variant.update(by)
