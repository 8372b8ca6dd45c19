"""Volume stage of the FR residual: fluxes + adjugate transform per point.

``volume_tdisf`` is the port of the JAX package's one Pallas kernel,
hifiles_tpu/solver/pallas_kernels.py::volume_tdisf_fm, written by hand in
CUDA C++ (csrc/volume_tdisf.cu).  ``volume_tdisf_ref`` is the same algebra
in torch ops: the CPU path and the reference the kernel is held against.

Layouts (elements minor, as the residual's state):
  u (U, F, E), grad (d, U, F, E), jg (d, d, U, E') with E' = E or 1
  -> tdisf (d, U, F, E),  tdisf[l][:, i] = sum_m jg[l][m] * f_i,m.
Coverage is the Pallas kernel's: d = 3, F = 5, constant viscosity
(fix_vis = 1), viscous or not.
"""

from __future__ import annotations

import ctypes

import torch

from .. import backend

D, F = 3, 5


def volume_tdisf_ref(u, grad, jg, *, gamma, mu, prandtl, viscous):
    """Plain torch version of the volume kernel (same algebra, same
    layouts).  ``grad`` is unused when not ``viscous``."""
    rho, mx, my, mz, en = u.unbind(1)
    inv_rho = 1.0 / rho
    m = (mx, my, mz)
    v = [mi * inv_rho for mi in m]
    q2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    p = (gamma - 1.0) * (en - 0.5 * rho * q2)
    hp = en + p
    # f[i][dd]: flux of field i along dimension dd
    f = [[m[dd] for dd in range(D)]]
    f += [[m[i] * v[dd] for dd in range(D)] for i in range(D)]
    f.append([hp * v[dd] for dd in range(D)])
    for i in range(D):
        f[1 + i][i] = f[1 + i][i] + p
    if viscous:
        g = [gl.unbind(1) for gl in grad.unbind(0)]      # g[dd][i]
        dv = [[(g[dd][1 + i] - v[i] * g[dd][0]) * inv_rho
               for dd in range(D)] for i in range(D)]
        inte = en * inv_rho - 0.5 * q2
        dint = [(g[dd][4] - (0.5 * q2 + inte) * g[dd][0]) * inv_rho
                - (v[0] * dv[0][dd] + v[1] * dv[1][dd] + v[2] * dv[2][dd])
                for dd in range(D)]
        div = dv[0][0] + dv[1][1] + dv[2][2]
        tau = [[mu * (dv[i][dd] + dv[dd][i]) for dd in range(D)]
               for i in range(D)]
        for i in range(D):
            tau[i][i] = tau[i][i] - 2.0 / 3.0 * mu * div
        kth = mu * gamma / prandtl
        for dd in range(D):
            for i in range(D):
                f[1 + i][dd] = f[1 + i][dd] - tau[i][dd]
            f[4][dd] = f[4][dd] - (v[0] * tau[0][dd] + v[1] * tau[1][dd]
                                   + v[2] * tau[2][dd] + kth * dint[dd])
    return torch.stack([
        torch.stack([jg[l, 0] * f[i][0] + jg[l, 1] * f[i][1]
                     + jg[l, 2] * f[i][2] for i in range(F)], dim=1)
        for l in range(D)])


def _check(u, grad, jg, viscous):
    if u.dim() != 3 or u.shape[1] != F:
        raise ValueError(f"u must be (U, {F}, E), got {tuple(u.shape)}")
    U, _, E = u.shape
    if (jg.dim() != 4 or jg.shape[:3] != (D, D, U)
            or jg.shape[3] not in (1, E)):
        raise ValueError(f"jg must be ({D}, {D}, {U}, {E} or 1), "
                         f"got {tuple(jg.shape)}")
    ts = [u, jg] + ([grad] if viscous else [])
    if viscous and tuple(grad.shape) != (D, U, F, E):
        raise ValueError(f"grad must be ({D}, {U}, {F}, {E}), "
                         f"got {tuple(grad.shape)}")
    for t in ts:
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError("u, grad and jg must share device and dtype")
        if not t.is_contiguous():
            raise ValueError("volume_tdisf takes contiguous tensors")
    if u.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {u.dtype}")


# (u, grad, jg, out, n_upts, n_eles, jg_ele_stride, gamma, mu, prandtl,
#  viscous, device, stream) -> cudaError_t of the launch
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 \
    + [ctypes.c_double] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _entry(dtype):
    name = ("hft_volume_tdisf_f32" if dtype == torch.float32
            else "hft_volume_tdisf_f64")
    fn = getattr(backend.kernel_library(), name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def volume_tdisf(u, grad, jg, *, gamma, mu, prandtl, viscous):
    """Volume stage: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  ``grad`` may be None when not ``viscous``.
    ``volume_tdisf.launches`` counts the kernel launches (CPU calls do not
    count)."""
    _check(u, grad, jg, viscous)
    if u.device.type == "cpu":
        return volume_tdisf_ref(u, grad, jg, gamma=gamma, mu=mu,
                                prandtl=prandtl, viscous=viscous)
    if u.device.type != "cuda":
        raise ValueError(f"volume_tdisf: unsupported device {u.device}")
    U, _, E = u.shape
    out = torch.empty((D, U, F, E), device=u.device, dtype=u.dtype)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = _entry(u.dtype)(
        u.data_ptr(), grad.data_ptr() if viscous else None, jg.data_ptr(),
        out.data_ptr(), U, E, 1 if jg.shape[3] == E and E > 1 else 0,
        float(gamma), float(mu), float(prandtl), int(bool(viscous)),
        u.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"volume_tdisf kernel launch failed: CUDA error "
                           f"{rc}")
    volume_tdisf.launches += 1
    return out


volume_tdisf.launches = 0
