"""Structure-of-arrays FR residual on torch: state (U, F, E), elements minor.

Port of hifiles_tpu/solver/residual_soa.py, main-path branch: interior
faces of a single-type mesh with uniform faces, 3-D Navier-Stokes or Euler
(constant viscosity), HLLC or Rusanov with LDG.  Anything else raises
NotImplementedError naming what is missing; the port never falls back to a
slower path.

Every operator application is one large GEMM over the solution-point axis
(``torch.matmul``, TF32 off), as the JAX package leaves them to XLA.  The
face stage uses flat slot tables instead of the JAX face groups: the opp_0
extrapolation is computed slot-minor, (F, E, Pf), so its (F, E*Pf) view is
indexed by slot = e*Pf + fpt (the ElementBlock's int_slot_l/int_slot_r),
and the common fluxes return to the element flux points with one indexed
store per face side.  The volume stage runs the hand-written CUDA kernel
(volume.volume_tdisf).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .elements import ElementBlock
from .residual import BlockArrays, ResidualConfig
from .volume import volume_tdisf

# hifiles_tpu.ops.riemann codes (that module imports JAX)
RUSANOV, HLLC = 0, 3


# ----------------------------------------------------------------------
# host-side tables
# ----------------------------------------------------------------------

class SoaTables:
    """Flat slot tables of the interior faces.

    ``slot_l``/``slot_r`` (nfp, Fi): the paired flux-point slots
    e*Pf + fpt of each face's two sides, oriented by the JAX rule (L = the
    side with the smaller local face, residual_soa.py:104-119) so that the
    face intermediates match the JAX ones."""

    def __init__(self, block: ElementBlock):
        ops = block.ops
        Pf = ops.n_fpts
        nfp = int(ops.n_fpts_per_face[0])
        slot_l = block.int_slot_l.copy()
        slot_r = block.int_slot_r.copy()
        # L/R is arbitrary physics-wise (the Riemann and LDG common fluxes
        # are antisymmetric under (l<->r, n->-n)); ties keep the original
        # side.  A swapped face lists its new l side in ascending local fpt
        # order, carrying the pairing along.
        swap = (slot_l % Pf)[:, 0] // nfp > (slot_r % Pf)[:, 0] // nfp
        if swap.any():
            sl, sr = slot_l[swap], slot_r[swap]
            o = np.argsort(sr % Pf, axis=1)
            slot_l[swap] = np.take_along_axis(sr, o, axis=1)
            slot_r[swap] = np.take_along_axis(sl, o, axis=1)
        # every element flux point is on exactly one face side (the JAX
        # ``sel`` table check, :262-274), so the write-back stores need no
        # atomics and leave no hole
        count = np.bincount(np.concatenate([slot_l.ravel(), slot_r.ravel()]),
                            minlength=block.n_eles * Pf)
        if not np.all(count == 1):
            raise NotImplementedError(
                "hifiles_tpu_torch residual: flux points not covered exactly "
                "once by interior faces")
        self.slot_l = np.ascontiguousarray(slot_l.T)
        self.slot_r = np.ascontiguousarray(slot_r.T)
        self.nfp, self.Pf = nfp, Pf


def _uniform_column(a, axis):
    """The first slice of ``a`` along ``axis`` when every slice equals it to
    1e-12 of its scale (affine uniform meshes, e.g. the TGV box), else
    None."""
    ref = np.take(a, [0], axis=axis)
    scale = np.abs(ref).max()
    if scale > 0 and np.all(np.abs(a - ref) <= 1e-12 * scale):
        return ref
    return None


class BlockArraysSoa:
    """Device-side constants in SoA layouts.

    Geometry is compressed as residual_soa.py:327-344 does: on a uniform
    mesh the element (or face) axis shrinks to 1 and broadcasts, unless
    HIFILES_NO_GEO_COMPRESS is set.  Each kernel operand (e.g. the d x d
    adjugate stack) is compressed as one array.  tdA is compressed whenever
    uniform and ignores HIFILES_NO_GEO_COMPRESS, as residual_soa.py:886-890
    does."""

    def __init__(self, block: ElementBlock, B: BlockArrays, T: SoaTables,
                 device, dtype):
        f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=device)
        no_compress = bool(os.environ.get("HIFILES_NO_GEO_COMPRESS"))

        def fgeo(a, axis):
            a = np.asarray(a)
            if a.shape[axis] > 1 and not no_compress:
                ref = _uniform_column(a, axis)
                if ref is not None:
                    a = ref
            return f(a)

        d, E, Pf = B.n_dims, B.n_eles, B.n_fpts
        self.opp_0 = B.opp_0
        self.opp_2_stack = B.opp_2_stack
        self.opp_5_stack = B.opp_5_stack
        self.opp_3 = B.opp_3
        self.opp_div_fused = B.opp_div_fused
        # solution points: adj(J)[l][m] (d, d, U, E'), 1/det (U, 1, E')
        self.jg_u = fgeo(block.jginv_upts.transpose(2, 3, 1, 0), axis=3)
        self.inv_det_u = fgeo(1.0 / block.detjac_upts.T, axis=1)[:, None, :]
        # interior faces: l-side unit normal (d, nfp, Fi')
        self.norm = fgeo(np.moveaxis(block.norm_fpts[T.slot_l], -1, 0),
                         axis=2)
        # element flux points, slot-minor: adj(J)[m][l] (d, d, E', Pf),
        # 1/det (E', Pf), outward normal (d, E', Pf)
        self.jg_f = fgeo(block.jginv_fpts.reshape(E, Pf, d, d)
                         .transpose(2, 3, 0, 1), axis=2)
        self.inv_det_f = fgeo(1.0 / block.detjac_fpts.reshape(E, Pf),
                              axis=0)
        self.norm_f = fgeo(block.norm_fpts.reshape(E, Pf, d)
                           .transpose(2, 0, 1), axis=1)
        tdA = block.tdA_fpts.reshape(E, Pf)
        ref = _uniform_column(tdA, 0)
        self.tdA = f(tdA if ref is None else ref)                  # (E', Pf)
        self.slot_l = torch.as_tensor(T.slot_l.reshape(-1), device=device)
        self.slot_r = torch.as_tensor(T.slot_r.reshape(-1), device=device)


# ----------------------------------------------------------------------
# plane-based physics (fields as a list of (..., E) planes)
# ----------------------------------------------------------------------

def _prims_p(u, norm, d, gamma):
    """u: list of F planes; norm: list of d planes."""
    rho = u[0]
    inv_rho = 1.0 / rho
    vel = [u[1 + m] * inv_rho for m in range(d)]
    vn = sum(vel[m] * norm[m] for m in range(d))
    vsq = sum(v * v for v in vel)
    p = (gamma - 1.0) * (u[d + 1] - 0.5 * rho * vsq)
    return rho, vel, vn, vsq, p


def _normal_flux_p(u, norm, d, gamma):
    rho, vel, vn, vsq, p = _prims_p(u, norm, d, gamma)
    mn = rho * vn
    return ([mn] + [u[1 + m] * vn + p * norm[m] for m in range(d)]
            + [(u[d + 1] + p) * vn])


def rusanov_p(u_l, u_r, norm, gamma, d):
    """ref:src/inters.cpp:277-324 on planes."""
    fn_l = _normal_flux_p(u_l, norm, d, gamma)
    fn_r = _normal_flux_p(u_r, norm, d, gamma)
    rho_l, _, vn_l, _, p_l = _prims_p(u_l, norm, d, gamma)
    rho_r, _, vn_r, _, p_r = _prims_p(u_r, norm, d, gamma)
    eig = (torch.sqrt(gamma * (p_l + p_r) / (rho_l + rho_r))
           + 0.5 * torch.abs(vn_l + vn_r))
    return [0.5 * ((fl + fr) - eig * (ur - ul))
            for fl, fr, ul, ur in zip(fn_l, fn_r, u_l, u_r)]


def hllc_p(u_l, u_r, norm, gamma, d):
    """HLLC with Roe-average wavespeeds (ref:src/inters.cpp:439-532)."""
    fn_l = _normal_flux_p(u_l, norm, d, gamma)
    fn_r = _normal_flux_p(u_r, norm, d, gamma)
    rho_l, _, vn_l, _, p_l = _prims_p(u_l, norm, d, gamma)
    rho_r, _, vn_r, _, p_r = _prims_p(u_r, norm, d, gamma)
    E_l, E_r = u_l[d + 1], u_r[d + 1]
    h_l = (E_l + p_l) / rho_l
    h_r = (E_r + p_r) / rho_r
    sq_rho = torch.sqrt(rho_r / rho_l)
    rrho = 1.0 / (sq_rho + 1.0)
    vn_m = rrho * (vn_l + sq_rho * vn_r)
    h_m = rrho * (h_l + sq_rho * h_r)
    a_m = torch.sqrt((gamma - 1.0) * (h_m - 0.5 * vn_m * vn_m))
    S_R = vn_m + a_m
    S_L = vn_m - a_m
    S_star = ((p_r - p_l + rho_l * vn_l * (S_L - vn_l)
               - rho_r * vn_r * (S_R - vn_r))
              / (rho_l * (S_L - vn_l) - rho_r * (S_R - vn_r)))

    def star(S, u, fn, rho, vn, p):
        rcp = 1.0 / (S - S_star)
        pre = p + rho * (S - vn) * (S_star - vn)
        out = [S_star * (S * u[0] - fn[0]) * rcp]
        for m in range(d):
            out.append((S_star * (S * u[1 + m] - fn[1 + m])
                        + S * pre * norm[m]) * rcp)
        out.append((S_star * (S * u[d + 1] - fn[d + 1])
                    + S * pre * S_star) * rcp)
        return out

    f_sl = star(S_L, u_l, fn_l, rho_l, vn_l, p_l)
    f_sr = star(S_R, u_r, fn_r, rho_r, vn_r, p_r)
    cl, cs, cr = S_L >= 0, S_star >= 0, S_R >= 0
    return [torch.where(cl, a, torch.where(cs, b, torch.where(cr, c, e)))
            for a, b, c, e in zip(fn_l, f_sl, f_sr, fn_r)]


def ldg_sign_p(norm, tol=1e-10):
    """Plane version of riemann.ldg_beta_switch."""
    n0 = norm[0]
    n01 = n0 + norm[1]
    one = torch.ones_like(n0)
    n02 = n0 + norm[2] if len(norm) == 3 else one
    return torch.where(
        n0 < -tol, -one,
        torch.where(n0 > tol, one,
                    torch.where(n01 < -tol, -one,
                                torch.where(n01 > tol, one,
                                            torch.where(n02 < -tol, -one,
                                                        one)))))


def visc_flux_p(u, gr, d, *, gamma, prandtl, mu_inf, rt_inf, c_sth,
                fix_vis):
    """Viscous flux planes: u F-list, gr [d][F]-list -> [d][F]-list
    (ref:src/flux.cpp:127-325); fix_vis 0 is Sutherland's law."""
    rho = u[0]
    inv_rho = 1.0 / rho
    v = [u[1 + m] * inv_rho for m in range(d)]
    q2 = sum(vi * vi for vi in v)
    inte = u[d + 1] * inv_rho - 0.5 * q2
    if fix_vis:
        mu = mu_inf
    else:
        rt_ratio = (gamma - 1.0) * inte / rt_inf
        mu = mu_inf * rt_ratio**1.5 * (1.0 + c_sth) / (rt_ratio + c_sth)
    kth = mu * gamma / prandtl
    dv = [[(gr[l][1 + i] - v[i] * gr[l][0]) * inv_rho for l in range(d)]
          for i in range(d)]
    dint = [(gr[l][d + 1] - (0.5 * q2 + inte) * gr[l][0]) * inv_rho
            - sum(v[i] * dv[i][l] for i in range(d)) for l in range(d)]
    div = sum(dv[i][i] for i in range(d))
    tau = [[mu * (dv[i][l] + dv[l][i]) for l in range(d)]
           for i in range(d)]
    for i in range(d):
        tau[i][i] = tau[i][i] - 2.0 / 3.0 * mu * div
    out = []
    for mm in range(d):
        rows = [torch.zeros_like(rho)]
        for i in range(d):
            rows.append(-tau[i][mm])
        rows.append(-(sum(v[i] * tau[i][mm] for i in range(d))
                      + kth * dint[mm]))
        out.append(rows)
    return out


# ----------------------------------------------------------------------
# the residual
# ----------------------------------------------------------------------

def unsupported(block: ElementBlock, cfg: ResidualConfig) -> list:
    """What this port does not cover yet for (block, cfg); empty when the
    residual can be built."""
    d = block.ops.n_dims
    missing = []
    if d != 3:
        missing.append(f"d={d} (the volume kernel is 3-D)")
    if cfg.equation != 0:
        missing.append("advection-diffusion (equation 1)")
    if cfg.riemann_solve_type not in (RUSANOV, HLLC):
        missing.append(f"riemann_solve_type {cfg.riemann_solve_type} "
                       "(RoeM / Lax-Friedrichs)")
    if cfg.viscous and cfg.fix_vis != 1:
        missing.append("Sutherland viscosity (fix_vis=0)")
    if cfg.over_int:
        missing.append("over-integration")
    if cfg.les:
        missing.append("LES")
    if cfg.rans:
        missing.append("SA-RANS")
    if cfg.n_fields != d + 2:
        missing.append(f"n_fields {cfg.n_fields}")
    if block.bdy_slot.size:
        missing.append("boundary faces")
    if not np.all(block.ops.n_fpts_per_face == block.ops.n_fpts_per_face[0]):
        missing.append("non-uniform faces")
    return missing


def make_residual_soa(block: ElementBlock, cfg: ResidualConfig, device,
                      dtype):
    """Build residual_soa(u) with u (U, F, E) -> rhs (U, F, E) on
    ``device``; raises NotImplementedError for configurations the port
    does not cover yet."""
    missing = unsupported(block, cfg)
    if missing:
        raise NotImplementedError("hifiles_tpu_torch residual: not ported "
                                  "yet: " + ", ".join(missing))
    B = BlockArrays(block, device, dtype)
    T = SoaTables(block)
    S = BlockArraysSoa(block, B, T, device, dtype)
    E, U, Pf, d = B.n_eles, B.n_upts, B.n_fpts, B.n_dims
    nF = cfg.n_fields
    nfp = T.nfp
    gamma, Pr = cfg.gamma, cfg.prandtl
    riemann = hllc_p if cfg.riemann_solve_type == HLLC else rusanov_p
    visc_kw = dict(gamma=gamma, prandtl=Pr, mu_inf=cfg.mu_inf,
                   rt_inf=cfg.rt_inf, c_sth=cfg.c_sth, fix_vis=cfg.fix_vis)
    norm = list(S.norm)

    def to_fpts(x):
        """(..., U, C, E) -> (..., C, E, Pf): the opp_0 extrapolation as one
        GEMM whose output is slot-minor (ref:src/eles.cpp:1360)."""
        *b, _, C, _ = x.shape
        y = torch.matmul(x.reshape(*b, U, C * E).transpose(-1, -2),
                         S.opp_0.T)
        return y.view(*b, C, E, Pf)

    def read_faces(x2, slots):
        """(C, E*Pf) -> (C, nfp, Fi): one side's face values."""
        return x2.index_select(1, slots).view(x2.shape[0], nfp, -1)

    def write_faces(v_l, v_r):
        """Per-side face values (C, nfp, Fi) -> element flux-point rows
        (C, E*Pf), the batched inverse of read_faces
        (ref:src/int_inters.cpp:217-220 writes point by point)."""
        C = v_l.shape[0]
        out = torch.empty((C, E * Pf), dtype=v_l.dtype, device=v_l.device)
        out.index_copy_(1, S.slot_l, v_l.reshape(C, -1))
        out.index_copy_(1, S.slot_r, v_r.reshape(C, -1))
        return out

    def lift(A, rows):
        """(K, Pf) @ flux-point rows (C, E*Pf) -> (K, C*E): the contraction
        over (local face, fpt) as one matmul."""
        return A @ rows.view(-1, Pf).T

    def residual_soa(u):
        u2 = u.reshape(U, nF * E)
        # 1. extrapolate to flux points: one GEMM
        uf = to_fpts(u)                                   # (F, E, Pf)
        uf2 = uf.view(nF, E * Pf)
        # 2. all interior faces at once
        u_l = read_faces(uf2, S.slot_l)                   # (F, nfp, Fi)
        u_r = read_faces(uf2, S.slot_r)

        # 3. viscous gradient path
        gr = None
        if cfg.viscous:
            tg = (S.opp_2_stack.view(d * U, U) @ u2).view(d, U, nF, E)
            sgn = ldg_sign_p(norm)
            bcoef = cfg.ldg_beta * sgn
            u_c = 0.5 * (u_l + u_r) - bcoef * (u_l - u_r)
            delta = write_faces(u_c - u_l, u_c - u_r)
            tg = tg + lift(S.opp_5_stack.view(d * U, Pf),
                           delta).view(d, U, nF, E)
            # physical gradient at upts: (1/det) JGinv^T . tg
            gr = torch.stack([
                sum(S.jg_u[m, l][:, None] * tg[m] for m in range(d))
                * S.inv_det_u for l in range(d)])         # (d, U, F, E)
            # element-side viscous NORMAL flux at every flux point, then
            # read per face side: one plane per field crosses the face
            # instead of d gradient planes
            tgf = to_fpts(tg)                             # (d, F, E, Pf)
            g_f = [(sum(S.jg_f[m, l] * tgf[m] for m in range(d))
                    * S.inv_det_f).unbind(0) for l in range(d)]
            fv_e = visc_flux_p(uf.unbind(0), g_f, d, **visc_kw)
            qn = torch.stack([sum(fv_e[m][i] * S.norm_f[m] for m in range(d))
                              for i in range(nF)]).view(nF, E * Pf)
            qn_l = read_faces(qn, S.slot_l)
            qn_r = read_faces(qn, S.slot_r)

        # 4. volume transformed flux: the hand kernel
        # (ref:src/eles.cpp:1415-1545)
        tdisf = volume_tdisf(u, gr, S.jg_u, gamma=gamma, mu=cfg.mu_inf,
                             prandtl=Pr, viscous=cfg.viscous)  # (d,U,F,E)

        # 5. common interface flux, all interior faces at once
        fn = torch.stack(riemann(u_l.unbind(0), u_r.unbind(0), norm,
                                 gamma, d))
        if cfg.viscous:
            # LDG common viscous flux (ref:src/inters.cpp:561-611); the r
            # side enters with a sign flip, n_r = -n_l
            bl = 0.5 + cfg.ldg_beta * sgn
            br = 0.5 - cfg.ldg_beta * sgn
            fn = fn + bl * qn_l - br * qn_r - cfg.ldg_tau * (u_r - u_l)
        # 6. write-back to element flux points + tdA scaling
        ntc = write_faces(fn, -fn).view(nF, E, Pf) * S.tdA
        # 7. divergence GEMMs (ref:src/eles.cpp:1654-1772)
        div = lift(S.opp_3, ntc.view(nF, E * Pf))
        div = div + S.opp_div_fused @ tdisf.view(d * U, nF * E)
        return -div.view(U, nF, E) * S.inv_det_u

    return residual_soa
