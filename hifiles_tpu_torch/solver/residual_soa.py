"""Structure-of-arrays FR residual on torch: state (U, F, E), elements minor.

Port of hifiles_tpu/solver/residual_soa.py for one single-type block with
uniform faces (quads, tris, hexes or tets; interior, cyclic and boundary
faces): 2-D or 3-D Navier-Stokes or Euler with
constant or Sutherland viscosity, Rusanov, RoeM or HLLC with LDG, and the
feature physics of the JAX path: the LES SGS models (eddy viscosity and
similarity; SVV filters the state in solver.py), over-integration and
SA-RANS.  Anything else raises NotImplementedError naming what is missing;
the port never falls back to a slower path.

Every operator application is one large GEMM over the solution-point axis
(``torch.matmul``, TF32 off), as the JAX package leaves them to XLA.  The
face stage uses flat slot tables instead of the JAX face groups: the opp_0
extrapolation is computed slot-minor, (F, E, Pf), so its (F, E*Pf) view is
indexed by slot = e*Pf + fpt (the ElementBlock's int_slot_l/int_slot_r),
and the common fluxes return to the element flux points with one indexed
store per face side.  The volume stage runs the hand-written CUDA kernel
(volume.volume_tdisf), twice per stage with over-integration.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..ops.les_filter import build_les_filter

from .elements import ElementBlock
from .residual import BlockArrays, ResidualConfig
from .volume import (SGS_NONE, SGS_SMAGORINSKY, SGS_WALE, VolumeParams,
                     sgs_flux_p, sgs_kwargs, softplus, sutherland_mu_p,
                     visc_flux_p, visc_kwargs, volume_tdisf)

# the Riemann solver codes of hifiles_tpu/ops/riemann.py (a JAX module)
RUSANOV, ROEM, HLLC = 0, 2, 3
# reference-element volume per element type, for the LES cutoff length
# (residual_soa.py:157-160 of the JAX package)
_REF_VOL = {1: 4.0, 4: 8.0, 0: 2.0, 2: 4.0 / 3.0, 3: 4.0}


# ----------------------------------------------------------------------
# host-side tables
# ----------------------------------------------------------------------

class SoaTables:
    """Flat slot tables of the faces.

    ``slot_l``/``slot_r`` (nfp, Fi): the paired flux-point slots
    e*Pf + fpt of each interior face's two sides, oriented by the JAX rule
    (L = the side with the smaller local face, residual_soa.py:104-119) so
    that the face intermediates match the JAX ones.  The pairing is point
    by point (the block matched the points by position), so the tri faces
    of tets, whose flux points turn with the face's orientation, need no
    rotation table or face groups.  ``slot_b`` (nfp, Fb): the slots of
    each boundary face (the block's bdy_slot)."""

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
        slot_b = block.bdy_slot.reshape(-1, nfp)
        # every element flux point is on exactly one face side, interior
        # or boundary (the JAX ``sel`` table check, :262-274), so the
        # write-back stores need no atomics and leave no hole
        count = np.bincount(np.concatenate([slot_l.ravel(), slot_r.ravel(),
                                            slot_b.ravel()]),
                            minlength=block.n_eles * Pf)
        if count.size != block.n_eles * Pf or not np.all(count == 1):
            raise NotImplementedError(
                "hifiles_tpu_torch residual: flux points not covered exactly "
                "once by the interior and boundary faces")
        self.slot_l = np.ascontiguousarray(slot_l.T)
        self.slot_r = np.ascontiguousarray(slot_r.T)
        self.slot_b = np.ascontiguousarray(slot_b.T)
        self.nfp, self.Pf, self.Fb = nfp, Pf, slot_b.shape[0]


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
        # boundary faces: slots and outward unit normal (d, nfp, Fb')
        self.slot_b = torch.as_tensor(T.slot_b.reshape(-1), device=device)
        if T.Fb:
            self.norm_b = fgeo(np.moveaxis(block.norm_fpts[T.slot_b], -1, 0),
                               axis=2)
        # LES cutoff length and wall distance (residual_soa.py:159-165,
        # :437-457 of the JAX package): (U, E') at solution points,
        # (E', Pf) at element flux points; 1e10 away from walls
        ops = block.ops
        cut = lambda det: (det * _REF_VOL[ops.ele_type]) ** (1.0 / d) \
            / (ops.order + 1)
        far = lambda a: np.full_like(a, 1e10)
        wd_u = block.wall_dist_upts
        wd_f = block.wall_dist_fpts
        self.delta_u = fgeo(cut(block.detjac_upts).T, axis=1)
        self.wdist_u = fgeo((far(block.detjac_upts) if wd_u is None
                             else wd_u).T, axis=1)
        self.delta_f = fgeo(cut(block.detjac_fpts).reshape(E, Pf), axis=0)
        self.wdist_f = fgeo((far(block.detjac_fpts) if wd_f is None
                             else wd_f).reshape(E, Pf), axis=0)
        # over-integration (de-aliasing) operators: interpolation to the
        # cubature points (C2, U), L2 projection back (U, C2), adj(J) at
        # the cubature points (d, d, C2, E')
        if block.jginv_over is not None:
            self.opp_over = f(block.opp_over)
            self.over_filter = f(block.over_filter)
            self.jg_o = fgeo(block.jginv_over.transpose(2, 3, 1, 0), axis=3)


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
    out = ([mn] + [u[1 + m] * vn + p * norm[m] for m in range(d)]
           + [(u[d + 1] + p) * vn])
    # SA working variable advects passively (ref:src/flux.cpp:55-59)
    for k in range(d + 2, len(u)):
        out.append(u[k] * vn)
    return out


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


def roem_p(u_l, u_r, norm, gamma, d):
    """RoeM scheme (ref:src/inters.cpp:327-437) on planes; the SA row's
    bdq term is zero."""
    F = len(u_l)
    fn_l = _normal_flux_p(u_l, norm, d, gamma)
    fn_r = _normal_flux_p(u_r, norm, d, gamma)
    rho_l, v_l, vn_l, _, p_l = _prims_p(u_l, norm, d, gamma)
    rho_r, v_r, vn_r, _, p_r = _prims_p(u_r, norm, d, gamma)
    E_l, E_r = u_l[d + 1], u_r[d + 1]
    h_l = (E_l + p_l) / rho_l
    h_r = (E_r + p_r) / rho_r
    drho, dp, dh, dvn = rho_r - rho_l, p_r - p_l, h_r - h_l, vn_r - vn_l
    sq_rho = torch.sqrt(rho_r / rho_l)
    rrho = 1.0 / (1.0 + sq_rho)
    ratr = sq_rho * rrho
    ra = sq_rho * rho_l
    ha = h_l * rrho + h_r * ratr
    va = [v_l[m] * rrho + v_r[m] * ratr for m in range(d)]
    qq = sum(v * v for v in va)
    va_n = sum(va[m] * norm[m] for m in range(d))
    aa = torch.sqrt((gamma - 1.0) * (ha - 0.5 * qq))
    rcp_aa = 1.0 / aa
    abs_ma = torch.abs(va_n * rcp_aa)
    b1 = torch.clamp(torch.maximum(va_n + aa, vn_r + aa), min=0.0)
    b2 = torch.clamp(torch.minimum(va_n - aa, vn_l - aa), max=0.0)
    b1b2 = b1 * b2
    rcp_b1_b2 = 1.0 / (b1 - b2)
    b1, b2, b1b2 = b1 * rcp_b1_b2, b2 * rcp_b1_b2, b1b2 * rcp_b1_b2
    h = 1.0 - torch.minimum(p_l / p_r, p_r / p_l)
    f_ = torch.where(abs_ma != 0.0, abs_ma**h, torch.ones_like(abs_ma))
    g_ = f_ / (1.0 + abs_ma)
    du = [ur - ul for ul, ur in zip(u_l, u_r)]
    du[d + 1] = rho_r * h_r - rho_l * h_l
    bdq0 = drho - f_ * dp * rcp_aa * rcp_aa
    bdq = [bdq0]
    for m in range(d):
        bdq.append(bdq0 * va[m] + ra * ((v_r[m] - v_l[m]) - norm[m] * dvn))
    bdq.append(bdq0 * ha + ra * dh)
    while len(bdq) < F:
        bdq.append(torch.zeros_like(bdq0))
    return [b1 * fl - b2 * fr + b1b2 * (duk - g_ * bq)
            for fl, fr, duk, bq in zip(fn_l, fn_r, du, bdq)]


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


def similarity_terms_p(u, dg_filter, d):
    """Leonard tensors on planes (ref:src/eles.cpp:2091-2218).
    ``dg_filter(x)`` applies the LES modal filter along the solution-point
    axis of a (U, K, E) stack.  Returns (Lu [n_pairs], Le [d]) plane
    lists."""
    F = len(u)
    rho = u[0]
    mom = [u[1 + i] for i in range(d)]
    inte_r = u[d + 1] - 0.5 * sum(m * m for m in mom) / rho
    rsq = rho * rho
    pairs = ([(0, 0), (1, 1), (0, 1)] if d == 2
             else [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)])
    uu = [mom[a] * mom[b] / rsq for a, b in pairs]
    ue = [mom[a] * inte_r / rsq for a in range(d)]
    # one filter GEMM over [u | uu | ue]
    filt = dg_filter(torch.stack(list(u) + uu + ue, dim=1))
    uf = [filt[:, k] for k in range(F)]
    Lu = [filt[:, F + k] for k in range(len(pairs))]
    Le = [filt[:, F + len(pairs) + k] for k in range(d)]
    rho_f = uf[0]
    mom_f = [uf[1 + i] for i in range(d)]
    inte_rf = uf[d + 1] - 0.5 * sum(m * m for m in mom_f) / rho_f
    rsq_f = rho_f * rho_f
    Lu = [Lu[k] - mom_f[a] * mom_f[b] / rsq_f
          for k, (a, b) in enumerate(pairs)]
    diag = sum(Lu[:d]) / 3.0
    Lu = [(Lu[k] - diag if k < d else Lu[k]) for k in range(len(pairs))]
    Le = [(Le[a] - mom_f[a] * inte_rf) / rsq_f for a in range(d)]
    return Lu, Le


def similarity_flux_p(u, Lu, Le, gamma, d):
    """Similarity SGS flux planes (ref:src/eles.cpp:2615-2644)."""
    F = len(u)
    rho = u[0]
    idx = [[0, 2], [2, 1]] if d == 2 else [[0, 3, 4], [3, 1, 5], [4, 5, 2]]
    out = []
    zero = torch.zeros_like(rho)
    for mm in range(d):
        rows = [zero]
        for i in range(d):
            rows.append(rho * Lu[idx[i][mm]])
        rows.append(gamma * rho * Le[mm])
        while len(rows) < F:
            rows.append(zero)
        out.append(rows)
    return out


def sa_source_p(u, gr, wdist, d, *, gamma, mu_inf, rt_inf, c_sth, fix_vis,
                kappa, c_v1, c_v2, c_v3, c_b1, c_b2, c_w2, c_w3, omega):
    """SA source on planes (ref:src/source.cpp:33-105)."""
    rho = u[0]
    inv_rho = 1.0 / rho
    v = [u[1 + m] * inv_rho for m in range(d)]
    nu_tilde_c = u[d + 2]
    nu_tilde = nu_tilde_c * inv_rho
    inte = u[d + 1] * inv_rho - 0.5 * sum(vi * vi for vi in v)
    mu = sutherland_mu_p(inte, gamma, mu_inf, rt_inf, c_sth, fix_vis)
    dv = [[(gr[l][1 + i] - v[i] * gr[l][0]) * inv_rho for l in range(d)]
          for i in range(d)]
    dnu = [(gr[l][d + 2] - gr[l][0] * nu_tilde) * inv_rho for l in range(d)]
    if d == 2:
        S = torch.abs(dv[1][0] - dv[0][1])
    else:
        wx = dv[2][1] - dv[1][2]
        wy = dv[0][2] - dv[2][0]
        wz = dv[1][0] - dv[0][1]
        S = torch.sqrt(wx * wx + wy * wy + wz * wz)
    chi = nu_tilde_c / mu
    psi = torch.where(chi <= 10.0, 0.05 * softplus(20.0 * chi), chi)
    f_v1 = chi**3 / (chi**3 + c_v1**3)
    f_v2 = 1.0 - psi / (1.0 + psi * f_v1)
    kd2 = kappa**2 * wdist * wdist
    mp_r = mu * psi * inv_rho
    S_bar = mp_r * mp_r * f_v2 / kd2
    S_tilde = torch.where(
        S_bar >= -c_v2 * S, S + S_bar,
        S + S * (c_v2**2 * S + c_v3 * S_bar)
        / ((c_v3 - 2.0 * c_v2) * S - S_bar))
    prod = c_b1 * S_tilde * mu * psi
    diff = (1.0 / omega) * c_b2 * rho * sum(dn * dn for dn in dnu)
    c_w1 = c_b1 / kappa**2 + (1.0 / omega) * (1.0 + c_b2)
    r = torch.clamp(mp_r / (S_tilde * kd2), max=10.0)
    g = r + c_w2 * (r**6 - r)
    f_w = g * ((1.0 + c_w3**6) / (g**6 + c_w3**6)) ** (1.0 / 6.0)
    dest = -c_w1 * rho * f_w * (mp_r / wdist) ** 2
    return prod + diff + dest


def _add(a, b):
    """[d][F] plane lists summed entry by entry."""
    return [[x + y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


# ----------------------------------------------------------------------
# the residual
# ----------------------------------------------------------------------

def unsupported(block: ElementBlock, cfg: ResidualConfig,
                bc_fns=None) -> list:
    """What this port does not cover yet for (block, cfg, bc_fns); empty
    when the residual can be built."""
    d = block.ops.n_dims
    missing = []
    if cfg.equation != 0:
        missing.append("advection-diffusion (equation 1)")
    if cfg.riemann_solve_type not in (RUSANOV, ROEM, HLLC):
        missing.append(f"riemann_solve_type {cfg.riemann_solve_type} "
                       "(Lax-Friedrichs)")
    if cfg.rans and cfg.riemann_solve_type == HLLC:
        # the JAX package runs it on its slot path (residual_soa.py:852)
        missing.append("SA-RANS with HLLC (its star states carry no SA "
                       "field)")
    if cfg.rans and not cfg.viscous:
        missing.append("inviscid SA-RANS")
    if cfg.over_int and block.jginv_over is None:
        missing.append("over-integration without its cubature geometry "
                       "(build_element_block over_int_order)")
    if cfg.n_fields != (d + 3 if cfg.rans else d + 2):
        missing.append(f"n_fields {cfg.n_fields}")
    if block.bdy_slot.size:
        if bc_fns is None:
            missing.append("boundary faces without boundary functions "
                           "(bc.make_bc_functions)")
        else:
            # turbulent inlets, AD_WALL
            missing += [m for m in bc_fns.missing if m not in missing]
    if not np.all(block.ops.n_fpts_per_face == block.ops.n_fpts_per_face[0]):
        missing.append("non-uniform faces")
    return missing


def make_residual_soa(block: ElementBlock, cfg: ResidualConfig, device,
                      dtype, bc_fns=None):
    """Build residual_soa(u, fluc=None, ramp=None) with u (U, F, E) ->
    rhs (U, F, E) on ``device``; ``bc_fns`` (bc.make_bc_functions) gives
    the boundary faces' common values and ``ramp`` (a 0-d tensor) the BC
    ramp counter.  Raises NotImplementedError for configurations the port
    does not cover yet."""
    missing = unsupported(block, cfg, bc_fns)
    if missing:
        raise NotImplementedError("hifiles_tpu_torch residual: not ported "
                                  "yet: " + ", ".join(missing))
    B = BlockArrays(block, device, dtype)
    T = SoaTables(block)
    S = BlockArraysSoa(block, B, T, device, dtype)
    E, U, Pf, d = B.n_eles, B.n_upts, B.n_fpts, B.n_dims
    nF = cfg.n_fields
    nfp = T.nfp
    has_bdy = T.Fb > 0
    if has_bdy:
        norm_b = list(S.norm_b)
        wm = bc_fns.wm_tables
    gamma = cfg.gamma
    riemann = {RUSANOV: rusanov_p, ROEM: roem_p,
               HLLC: hllc_p}[cfg.riemann_solve_type]
    # LES model dispatch (ref:src/eles.cpp:2437-2461): eddy-viscosity part
    # for Smagorinsky/WALE/WALE-similarity, Leonard part for (WALE-)
    # similarity; SVV (model 3) filters the state per step in solver.py
    use_eddy = cfg.les and cfg.sgs_model in (0, 1, 2) and cfg.viscous
    use_similarity = cfg.les and cfg.sgs_model in (2, 4) and cfg.viscous
    prm = VolumeParams(
        gamma=gamma, prandtl=cfg.prandtl, mu=cfg.mu_inf,
        viscous=cfg.viscous, fix_vis=cfg.fix_vis, rt_inf=cfg.rt_inf,
        c_sth=cfg.c_sth, prandtl_t=cfg.prandtl_t, c_v1=cfg.c_v1,
        omega=cfg.omega, C_s=cfg.C_s, kappa=cfg.kappa,
        sgs=(SGS_NONE if not use_eddy else
             SGS_SMAGORINSKY if cfg.sgs_model == 0 else SGS_WALE))
    visc_kw = visc_kwargs(prm, nF, d)
    sgs_kw = sgs_kwargs(prm)
    sa_kw = dict(gamma=gamma, mu_inf=cfg.mu_inf, rt_inf=cfg.rt_inf,
                 c_sth=cfg.c_sth, fix_vis=cfg.fix_vis, kappa=cfg.kappa,
                 c_v1=cfg.c_v1, c_v2=cfg.c_v2, c_v3=cfg.c_v3, c_b1=cfg.c_b1,
                 c_b2=cfg.c_b2, c_w2=cfg.c_w2, c_w3=cfg.c_w3,
                 omega=cfg.omega)
    delta_u = wdist_u = None
    if use_eddy:
        # SGS cutoff = filter_ratio * Deardorff delta (ref:src/eles.cpp:2480)
        delta_u, wdist_u = cfg.filter_ratio * S.delta_u, S.wdist_u
        delta_f = cfg.filter_ratio * S.delta_f
    if use_similarity:
        les_filter = torch.as_tensor(
            build_les_filter(block.ops, cfg.filter_type, cfg.filter_ratio),
            dtype=dtype, device=device)

        def dg_filter(x):
            """(U, K, E) -> the LES filter along the solution points."""
            return (les_filter @ x.reshape(U, -1)).view(x.shape)
    if cfg.over_int:
        # de-aliasing: the inviscid part at the cubature points, L2-
        # projected back; the viscous (+SGS) part at the solution points
        C2 = S.opp_over.shape[0]
        prm_over = dataclasses.replace(prm, viscous=False, sgs=SGS_NONE)
        prm_visc = dataclasses.replace(prm, inviscid=False)
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

    def write_faces(v_l, v_r, v_b=None):
        """Per-side face values (C, nfp, Fi), and the boundary faces' values
        (C, nfp, Fb) -> element flux-point rows (C, E*Pf), the batched
        inverse of read_faces (ref:src/int_inters.cpp:217-220 writes point
        by point)."""
        C = v_l.shape[0]
        out = torch.empty((C, E * Pf), dtype=v_l.dtype, device=v_l.device)
        out.index_copy_(1, S.slot_l, v_l.reshape(C, -1))
        out.index_copy_(1, S.slot_r, v_r.reshape(C, -1))
        if v_b is not None:
            out.index_copy_(1, S.slot_b, v_b.reshape(C, -1))
        return out

    def lift(A, rows):
        """(K, Pf) @ flux-point rows (C, E*Pf) -> (K, C*E): the contraction
        over (local face, fpt) as one matmul."""
        return A @ rows.view(-1, Pf).T

    def residual_soa(u, fluc=None, ramp=None):
        if fluc is not None:
            raise NotImplementedError(
                "hifiles_tpu_torch residual: not ported yet: turbulent-inlet "
                "fluctuations (fluc)")
        u2 = u.reshape(U, nF * E)
        # 1. extrapolate to flux points: one GEMM
        uf = to_fpts(u)                                   # (F, E, Pf)
        uf2 = uf.view(nF, E * Pf)
        # 2. all interior faces at once; the boundary faces' own states
        # and their inviscid ghost states (bc.py; JAX reads them from the
        # same extrapolation, residual_soa.py:1042-1047)
        u_l = read_faces(uf2, S.slot_l)                   # (F, nfp, Fi)
        u_r = read_faces(uf2, S.slot_r)
        if has_bdy:
            u_b = read_faces(uf2, S.slot_b).unbind(0)     # F x (nfp, Fb)
            g0_b = bc_fns.ghost_state(u_b, norm_b, 0, ramp)

        # 3. viscous gradient path
        gr = extra = None
        if cfg.viscous:
            tg = (S.opp_2_stack.view(d * U, U) @ u2).view(d, U, nF, E)
            sgn = ldg_sign_p(norm)
            bcoef = cfg.ldg_beta * sgn
            u_c = 0.5 * (u_l + u_r) - bcoef * (u_l - u_r)
            delta_b = None
            if has_bdy:
                # boundary LDG common solution (residual_soa.py:1068-1071)
                u_c_b = bc_fns.ldg_solution(u_b, norm_b, g0_b, ramp)
                delta_b = torch.stack([c - a for c, a in zip(u_c_b, u_b)])
            delta = write_faces(u_c - u_l, u_c - u_r, delta_b)
            tg = tg + lift(S.opp_5_stack.view(d * U, Pf),
                           delta).view(d, U, nF, E)
            # physical gradient at upts: (1/det) JGinv^T . tg
            gr = torch.stack([
                sum(S.jg_u[m, l][:, None] * tg[m] for m in range(d))
                * S.inv_det_u for l in range(d)])         # (d, U, F, E)
            # element-side viscous (+SGS) NORMAL flux at every flux point,
            # then read per face side: one plane per field crosses the
            # face instead of d gradient planes
            tgf = to_fpts(tg)                             # (d, F, E, Pf)
            g_f = [(sum(S.jg_f[m, l] * tgf[m] for m in range(d))
                    * S.inv_det_f) for l in range(d)]     # d x (F, E, Pf)
            if has_bdy:
                # physical gradient at the boundary flux points (JAX:
                # adjT_apply on the boundary rows, residual_soa.py:1211)
                g_b = [read_faces(g.view(nF, E * Pf), S.slot_b).unbind(0)
                       for g in g_f]
            g_f = [g.unbind(0) for g in g_f]
            u_f = uf.unbind(0)
            fv_e = visc_flux_p(u_f, g_f, d, **visc_kw)
            if use_eddy:
                fv_e = _add(fv_e, sgs_flux_p(u_f, g_f, delta_f, S.wdist_f,
                                             d, **sgs_kw))
            if use_similarity:
                up = u.unbind(1)
                Lu, Le = similarity_terms_p(up, dg_filter, d)
                extra = torch.stack([torch.stack(r, dim=1) for r in
                                     similarity_flux_p(up, Lu, Le, gamma,
                                                       d)])  # (d,U,F,E)
                # extrapolated for all dims in one GEMM (ref:src/eles.cpp:
                # 2817)
                fv_e = _add(fv_e, [x.unbind(0) for x in to_fpts(extra)])
            qn = torch.stack([sum(fv_e[m][i] * S.norm_f[m] for m in range(d))
                              for i in range(nF)]).view(nF, E * Pf)
            qn_l = read_faces(qn, S.slot_l)
            qn_r = read_faces(qn, S.slot_r)

        # 4. volume transformed flux: the hand kernel
        # (ref:src/eles.cpp:1415-1545)
        if cfg.over_int:
            u_o = (S.opp_over @ u2).view(C2, nF, E)
            t_o = volume_tdisf(u_o, None, S.jg_o, prm_over)   # (d,C2,F,E)
            tdisf = (S.over_filter @ t_o.view(d, C2, nF * E)).view(
                d, U, nF, E)
            if cfg.viscous:
                # the JAX branch leaves the similarity flux out of the
                # volume term here (residual_soa.py:1114-1126)
                tdisf = tdisf + volume_tdisf(u, gr, S.jg_u, prm_visc,
                                             delta_u, wdist_u)
        else:
            tdisf = volume_tdisf(u, gr, S.jg_u, prm, delta_u, wdist_u,
                                 extra)                   # (d, U, F, E)

        # 5. common interface flux, all interior faces at once
        fn = torch.stack(riemann(u_l.unbind(0), u_r.unbind(0), norm,
                                 gamma, d))
        if cfg.viscous:
            # LDG common viscous flux (ref:src/inters.cpp:561-611); the r
            # side enters with a sign flip, n_r = -n_l
            bl = 0.5 + cfg.ldg_beta * sgn
            br = 0.5 - cfg.ldg_beta * sgn
            fn = fn + bl * qn_l - br * qn_r - cfg.ldg_tau * (u_r - u_l)
        fn_b = None
        if has_bdy:
            # boundary common flux (residual_soa.py:1198-1226): Riemann
            # against the ghost state plus the boundary viscous flux,
            # which carries no SGS term (bc.py:413-417)
            fn_b = bc_fns.inv_common_flux(u_b, norm_b, g0_b)
            if cfg.viscous:
                wm_state = None
                if wm is not None:
                    # wall-model input state u[wm_upt, :, wm_ele]
                    # (residual_soa.py:1213-1222) as F planes (1, Fb)
                    wm_state = u[wm[1], :, wm[0]].T[:, None].unbind(0)
                fv_b = bc_fns.visc_common_flux(u_b, g_b, norm_b, u_c_b,
                                               wm_state)
                fn_b = [a + b for a, b in zip(fn_b, fv_b)]
            fn_b = torch.stack(fn_b)
        # 6. write-back to element flux points + tdA scaling
        ntc = write_faces(fn, -fn, fn_b).view(nF, E, Pf) * S.tdA
        # 7. divergence GEMMs (ref:src/eles.cpp:1654-1772)
        div = lift(S.opp_3, ntc.view(nF, E * Pf))
        div = div + S.opp_div_fused @ tdisf.view(d * U, nF * E)
        rhs = -div.view(U, nF, E) * S.inv_det_u
        if cfg.rans:
            # SA source (ref:src/eles.cpp:2650, ref:src/source.cpp:33-105)
            rhs[:, d + 2] += sa_source_p(
                u.unbind(1), [g.unbind(1) for g in gr], S.wdist_u, d,
                **sa_kw)
        return rhs

    return residual_soa
