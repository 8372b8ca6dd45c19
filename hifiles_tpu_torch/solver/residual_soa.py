"""Structure-of-arrays FR residual on torch: state (U, F, E), elements minor.

Port of hifiles_tpu/solver/residual_soa.py: 2-D or 3-D Navier-Stokes or
Euler with constant or Sutherland viscosity, Rusanov, RoeM or HLLC with
LDG, boundary faces with the turbulent inlet's fluctuations, the feature
physics of the JAX path (the LES SGS models: eddy viscosity and
similarity; SVV filters the state in the solver; over-integration and
SA-RANS), and scalar advection-diffusion (equation 1) with the
Lax-Friedrichs flux.  Anything else raises NotImplementedError naming what
is missing; the port never falls back to a slower path.

Every operator application is one large GEMM over the solution-point axis
(``torch.matmul``, TF32 off), as the JAX package leaves them to XLA.  The
face stage uses flat slot tables instead of the JAX face groups: the opp_0
extrapolation is computed slot-minor, (F, E, Pf), so its (F, E*Pf) view is
indexed by slot = e*Pf + fpt, and the common fluxes return to the element
flux points with one indexed store per face side.  The volume stage runs
the hand-written CUDA kernel: one grouped launch for every block of the
stage (volume.volume_tdisf_many, driven through the residual's volume
request), or twice per block and stage with over-integration.  The
gradient path's element side is hand-written CUDA too (K3,
ldg_element.py): the physical gradient at the solution points, and at the
flux points the gradient, the viscous flux and its normal projection in
one pass, one launch each per block and stage.  The interior faces'
common flux is K4 (common_flux.py): the Riemann and LDG fluxes of every
interior face point and their write-back to the flux-point slots in one
launch a stage.

The face stage (``make_face_residual``) works on one or several element
blocks: the blocks' flux-point rows side by side, (F, sum_t E_t*Pf_t), are
the global slot space of a mixed mesh (residual_mixed_soa.py), and one
block is the single-type case (``make_residual_soa``).  ``SoaTables`` and
``residual_mixed_soa.MixedSoaTables`` give it the slots to read and write
and the shape of the face planes.  The tables of one shard of an
element-sharded run (parallel/soa_sharding.py) add a third face class, the
halo faces, whose other side lives on another shard: the face stage then
stops at the two halo exchanges (``residual.stages``), and every stage
generator stops once at its volume request, so that the shards of a card
share its launch.  Its operations run in the tracing parts
residual.face_states, residual.gradient, residual.volume,
residual.common_flux and residual.divergence (tracing.part), none open
across a stop; with boundary faces, the boundary functions (bc.py) and
the reads and stacks that only they use run in residual.boundary, twice a
stage: the boundary states before the gradient, the boundary common flux
after the interior one.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import tracing
from ..models.viscous import adv_diff_viscous_flux
from ..ops.les_filter import build_les_filter

from .common_flux import common_flux
from .elements import ElementBlock
from .ldg_element import (flux_point_qn, solution_point_gradient,
                          solution_point_gradient_ref)
from .residual import BlockArrays, ResidualConfig
from .volume import (SGS_NONE, SGS_SMAGORINSKY, SGS_WALE, VolumeCall,
                     VolumeParams, VolumeRequest, _library, softplus,
                     sutherland_mu_p, volume_tdisf_many)

# the Riemann solver codes of hifiles_tpu/ops/riemann.py (a JAX module)
RUSANOV, ROEM, HLLC = 0, 2, 3
# reference-element volume per element type, for the LES cutoff length
# (residual_soa.py:157-160 of the JAX package)
_REF_VOL = {1: 4.0, 4: 8.0, 0: 2.0, 2: 4.0 / 3.0, 3: 4.0}


# ----------------------------------------------------------------------
# host-side tables
# ----------------------------------------------------------------------

def check_coverage(slots, n_slots):
    """Every element flux point is on exactly one face side, interior,
    boundary or halo (the JAX ``sel`` table check, residual_soa.py:262-274),
    so the write-back stores need no atomics and leave no hole."""
    count = np.bincount(np.concatenate([s.ravel() for s in slots]),
                        minlength=n_slots)
    if count.size != n_slots or not np.all(count == 1):
        raise NotImplementedError(
            "hifiles_tpu_torch residual: flux points not covered exactly "
            "once by the interior, boundary and halo faces")


def orient_faces(slot_l, slot_r, Pf, nfp):
    """Interior faces (Fi, nfp) of one element type oriented by the JAX
    rule (L = the side with the smaller local face, residual_soa.py:104-119)
    so that the face intermediates match the JAX ones.  L/R is arbitrary
    physics-wise (the Riemann and LDG common fluxes are antisymmetric under
    (l<->r, n->-n)); ties keep the original side.  A swapped face lists its
    new l side in ascending local fpt order, carrying the pairing along."""
    slot_l, slot_r = slot_l.copy(), slot_r.copy()
    swap = (slot_l % Pf)[:, 0] // nfp > (slot_r % Pf)[:, 0] // nfp
    if swap.any():
        sl, sr = slot_l[swap], slot_r[swap]
        o = np.argsort(sr % Pf, axis=1)
        slot_l[swap] = np.take_along_axis(sr, o, axis=1)
        slot_r[swap] = np.take_along_axis(sl, o, axis=1)
    return slot_l, slot_r


class SoaTables:
    """Flat slot tables of one block's faces.

    ``slot_l``/``slot_r`` (nfp, Fi): the paired flux-point slots
    e*Pf + fpt of each interior face's two sides, oriented by the JAX rule
    (L = the side with the smaller local face, residual_soa.py:104-119) so
    that the face intermediates match the JAX ones.  The pairing is point
    by point (the block matched the points by position), so the tri faces
    of tets, whose flux points turn with the face's orientation, need no
    rotation table or face groups.  ``slot_b`` (nfp, Fb): the slots of
    each boundary face (the block's bdy_slot).  The face planes are
    (nfp, faces), and the face normals compress along the face axis."""

    compress = True

    def __init__(self, block: ElementBlock):
        ops = block.ops
        Pf = ops.n_fpts
        nfp = int(ops.n_fpts_per_face[0])
        slot_l, slot_r = orient_faces(block.int_slot_l, block.int_slot_r,
                                      Pf, nfp)
        slot_b = block.bdy_slot.reshape(-1, nfp)
        check_coverage([slot_l, slot_r, slot_b], block.n_eles * Pf)
        self.slot_l = np.ascontiguousarray(slot_l.T)
        self.slot_r = np.ascontiguousarray(slot_r.T)
        self.slot_b = np.ascontiguousarray(slot_b.T)
        self.nfp, self.Pf, self.Fb = nfp, Pf, slot_b.shape[0]
        self.norm_fpts = block.norm_fpts


def _uniform_column(a, axis):
    """The first slice of ``a`` along ``axis`` when every slice equals it to
    1e-12 of its scale (affine uniform meshes, e.g. the TGV box), else
    None."""
    ref = np.take(a, [0], axis=axis)
    scale = np.abs(ref).max()
    if scale > 0 and np.all(np.abs(a - ref) <= 1e-12 * scale):
        return ref
    return None


def _tensor(a, device, dtype):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def _geometry(a, axis, device, dtype):
    """``a`` as a tensor, its ``axis`` shrunk to 1 when every slice along
    it is the same (residual_soa.py:327-344 of the JAX package), unless
    HIFILES_NO_GEO_COMPRESS is set."""
    a = np.asarray(a)
    if a.shape[axis] > 1 and not os.environ.get("HIFILES_NO_GEO_COMPRESS"):
        ref = _uniform_column(a, axis)
        if ref is not None:
            a = ref
    return _tensor(a, device, dtype)


class BlockArraysSoa:
    """One block's device-side constants in SoA layouts.

    Geometry is compressed as residual_soa.py:327-344 does: on a uniform
    block the element axis shrinks to 1 and broadcasts, unless
    HIFILES_NO_GEO_COMPRESS is set.  Each kernel operand (e.g. the d x d
    adjugate stack) is compressed as one array.  tdA is compressed whenever
    uniform and ignores HIFILES_NO_GEO_COMPRESS, as residual_soa.py:886-890
    does."""

    def __init__(self, block: ElementBlock, B: BlockArrays, device, dtype):
        f = lambda a: _tensor(a, device, dtype)
        fgeo = lambda a, axis: _geometry(a, axis, device, dtype)
        d, E, Pf = B.n_dims, B.n_eles, B.n_fpts
        self.opp_0 = B.opp_0
        self.opp_2_stack = B.opp_2_stack
        self.opp_5_stack = B.opp_5_stack
        self.opp_3 = B.opp_3
        self.opp_div_fused = B.opp_div_fused
        # solution points: adj(J)[l][m] (d, d, U, E'), 1/det (U, 1, E')
        self.jg_u = fgeo(block.jginv_upts.transpose(2, 3, 1, 0), axis=3)
        self.inv_det_u = fgeo(1.0 / block.detjac_upts.T, axis=1)[:, None, :]
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


class FaceArrays:
    """The face tables ``T`` (SoaTables, MixedSoaTables or a shard's
    soa_sharding.ShardSoaTables) on the device: the slot index tensors, the
    shapes of the face planes, and the unit normals at the faces' l side
    and at the boundary faces (d planes each), compressed along the face
    axis where ``T.compress``.  ``sharded`` when ``T`` has halo faces,
    whose columns then follow the interior faces' in the face planes:
    ``slot_l`` reads their own side after the interior faces' l side, and
    the r planes, read at ``slot_r`` (``shape_r``, the interior faces
    only), end with their partner's side, read from the receive buffer at
    ``recv_idx`` (``shape_h``); ``send`` lists the slots whose values the
    shard sends, every ring offset's end to end."""

    def __init__(self, T, device, dtype):
        idx = lambda a: torch.as_tensor(a.reshape(-1), device=device)
        self.sharded = getattr(T, "slot_h", None) is not None
        slot_l = (np.concatenate([T.slot_l, T.slot_h], axis=-1)
                  if self.sharded else T.slot_l)
        self.slot_l, self.slot_r = idx(slot_l), idx(T.slot_r)
        self.slot_b = idx(T.slot_b)
        self.shape_i, self.shape_r = slot_l.shape, T.slot_r.shape
        self.n_r = T.slot_r.shape[-1]
        self.shape_b = T.slot_b.shape[:-1] + (-1,)
        self.n_cols_b = T.slot_b.shape[-1]
        self.has_bdy = T.slot_b.size > 0

        def normals(slots):
            n = np.moveaxis(T.norm_fpts[slots], -1, 0)
            if T.compress:
                return _geometry(n, n.ndim - 1, device, dtype)
            return _tensor(n, device, dtype)
        self.norm_t = normals(slot_l)              # (d, *face plane)
        self.norm = list(self.norm_t)
        if self.has_bdy:
            self.norm_b = list(normals(T.slot_b))
        if self.sharded:
            self.recv_idx, self.send = idx(T.recv_idx), idx(T.send)
            self.shape_h = T.slot_h.shape


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


def lf_p(u_l, u_r, norm, wave_speed, lam):
    """Scalar advection LF flux (ref:src/inters.cpp:535-557) on planes."""
    u_av = 0.5 * (u_l[0] + u_r[0])
    u_diff = u_l[0] - u_r[0]
    ns = sum(wave_speed[m] * norm[m] for m in range(len(norm)))
    return [ns * u_av + 0.5 * lam * torch.abs(ns) * u_diff]


def adv_diff_flux_p(gr, diff_coeff):
    """Equation 1's viscous flux planes [d][1] from the gradient planes
    [d][1] (ref:src/flux.cpp:243-247)."""
    return [[adv_diff_viscous_flux(g, diff_coeff) for g in row]
            for row in gr]


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


# ----------------------------------------------------------------------
# the residual
# ----------------------------------------------------------------------

def config_missing(cfg: ResidualConfig, d: int, blocks, has_bdy: bool,
                   bc_fns=None) -> list:
    """What this port does not cover yet for ``cfg`` at dimension ``d`` on
    the element blocks ``blocks`` with (``has_bdy``) boundary faces and
    the boundary functions ``bc_fns``."""
    missing = []
    if cfg.rans and cfg.riemann_solve_type == HLLC:
        # the deck parsers refuse the pair (config/params.py:467-471, as
        # the JAX package's do), and no JAX path runs it: its HLLC builds
        # d + 2 flux columns
        missing.append("SA-RANS with HLLC (the deck rule refuses RANS with "
                       "Roe/HLLC fluxes; its star states carry no SA "
                       "field)")
    if cfg.rans and not cfg.viscous:
        missing.append("inviscid SA-RANS")
    if cfg.over_int and any(b.jginv_over is None for b in blocks):
        missing.append("over-integration without its cubature geometry "
                       "(build_element_block over_int_order)")
    n_fields = 1 if cfg.equation == 1 else d + 3 if cfg.rans else d + 2
    if cfg.n_fields != n_fields:
        missing.append(f"n_fields {cfg.n_fields}")
    if has_bdy and bc_fns is None:
        missing.append("boundary faces without boundary functions "
                       "(bc.make_bc_functions)")
    return missing


def unsupported(block: ElementBlock, cfg: ResidualConfig,
                bc_fns=None) -> list:
    """What this port does not cover yet for (block, cfg, bc_fns) on one
    block; empty when the residual can be built."""
    missing = config_missing(cfg, block.ops.n_dims, [block],
                             block.bdy_slot.size > 0, bc_fns)
    if not np.all(block.ops.n_fpts_per_face == block.ops.n_fpts_per_face[0]):
        missing.append("non-uniform faces (MixedSolver)")
    return missing


def riemann_of(cfg: ResidualConfig, d: int):
    """The interface flux f(u_l, u_r, norm, gamma, d) on planes: by
    riemann_solve_type for equation 0, Lax-Friedrichs for equation 1
    (residual_soa.py:943-954 of the JAX package, which raises ValueError
    for any other type with equation 0)."""
    if cfg.equation == 1:
        ws = [float(cfg.wave_speed[m]) for m in range(d)]
        return lambda u_l, u_r, norm, gamma, d: lf_p(u_l, u_r, norm, ws,
                                                    cfg.lambda_lf)
    solvers = {RUSANOV: rusanov_p, ROEM: roem_p, HLLC: hllc_p}
    if cfg.riemann_solve_type not in solvers:
        raise ValueError(f"riemann_solve_type {cfg.riemann_solve_type}")
    return solvers[cfg.riemann_solve_type]


class Physics:
    """What a residual computes, read from its ResidualConfig at dimension
    d: the volume kernel's parameters, the keywords of the plane physics,
    the LES model dispatch and the interface Riemann solver."""

    def __init__(self, cfg: ResidualConfig, d: int):
        self.cfg, self.d, self.nF = cfg, d, cfg.n_fields
        self.scalar = cfg.equation == 1
        self.riemann = riemann_of(cfg, d)
        # LES model dispatch (ref:src/eles.cpp:2437-2461): eddy-viscosity
        # part for Smagorinsky/WALE/WALE-similarity, Leonard part for
        # (WALE-)similarity; SVV (model 3) filters the state per step in
        # the solver.  Equation 1's flux carries neither (residual_soa.py:
        # 1095-1096, :1159-1160)
        les = cfg.les and cfg.viscous and not self.scalar
        self.use_eddy = les and cfg.sgs_model in (0, 1, 2)
        self.use_similarity = les and cfg.sgs_model in (2, 4)
        self.prm = VolumeParams(
            gamma=cfg.gamma, prandtl=cfg.prandtl, mu=cfg.mu_inf,
            viscous=cfg.viscous, fix_vis=cfg.fix_vis, rt_inf=cfg.rt_inf,
            c_sth=cfg.c_sth, prandtl_t=cfg.prandtl_t, c_v1=cfg.c_v1,
            omega=cfg.omega, C_s=cfg.C_s, kappa=cfg.kappa,
            sgs=(SGS_NONE if not self.use_eddy else
                 SGS_SMAGORINSKY if cfg.sgs_model == 0 else SGS_WALE))
        # over-integration (de-aliasing): the inviscid part at the
        # cubature points, L2-projected back; the viscous (+SGS) part at
        # the solution points
        self.prm_over = dataclasses.replace(self.prm, viscous=False,
                                            sgs=SGS_NONE)
        self.prm_visc = dataclasses.replace(self.prm, inviscid=False)
        self.sa_kw = dict(
            gamma=cfg.gamma, mu_inf=cfg.mu_inf, rt_inf=cfg.rt_inf,
            c_sth=cfg.c_sth, fix_vis=cfg.fix_vis, kappa=cfg.kappa,
            c_v1=cfg.c_v1, c_v2=cfg.c_v2, c_v3=cfg.c_v3, c_b1=cfg.c_b1,
            c_b2=cfg.c_b2, c_w2=cfg.c_w2, c_w3=cfg.c_w3, omega=cfg.omega)


class BlockStages:
    """The stages of the residual that run on one element block, on its
    (U, F, E) state: the opp_0 extrapolation, the gradient with its face
    lift, the element-side viscous flux at the flux points, the volume
    kernel and the divergence."""

    def __init__(self, block: ElementBlock, ph: Physics, device, dtype):
        cfg = ph.cfg
        self.ph = ph
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is not None and not ph.scalar:
            # the volume kernel's library, built by nvcc on a checkout's
            # first run, loaded with the residual rather than at its first
            # launch
            _library(dev)
        B = BlockArrays(block, device, dtype)
        self.S = S = BlockArraysSoa(block, B, device, dtype)
        self.E, self.U, self.Pf = B.n_eles, B.n_upts, B.n_fpts
        self.n_slots = self.E * self.Pf
        self.delta_u = self.wdist_u = self.delta_f = self.wdist_f = None
        if ph.use_eddy:
            # SGS cutoff = filter_ratio * Deardorff delta
            # (ref:src/eles.cpp:2480)
            self.delta_u, self.wdist_u = (cfg.filter_ratio * S.delta_u,
                                          S.wdist_u)
            self.delta_f, self.wdist_f = (cfg.filter_ratio * S.delta_f,
                                          S.wdist_f)
        if ph.use_similarity:
            self.les_filter = _tensor(
                build_les_filter(block.ops, cfg.filter_type,
                                 cfg.filter_ratio), device, dtype)

    def dg_filter(self, x):
        """(U, K, E) -> the LES filter along the solution points."""
        return (self.les_filter @ x.reshape(self.U, -1)).view(x.shape)

    def to_fpts(self, x):
        """(..., U, C, E) -> (..., C, E, Pf): the opp_0 extrapolation as one
        GEMM whose output is slot-minor (ref:src/eles.cpp:1360)."""
        U, E = self.U, self.E
        *b, _, C, _ = x.shape
        y = torch.matmul(x.reshape(*b, U, C * E).transpose(-1, -2),
                         self.S.opp_0.T)
        return y.view(*b, C, E, self.Pf)

    def lift(self, A, rows):
        """(K, Pf) @ flux-point rows (C, E, Pf) -> (K, C*E): the
        contraction over (local face, fpt) as one matmul."""
        return A @ rows.reshape(-1, self.Pf).T

    def tgrad(self, u):
        """The transformed gradient's volume part (d, U, F, E)."""
        d, U, (_, nF, E) = self.ph.d, self.U, u.shape
        return (self.S.opp_2_stack.view(d * U, U) @ u.reshape(U, nF * E)
                ).view(d, U, nF, E)

    def gradient(self, tg, delta):
        """(tg with the lift of the face corrections ``delta`` (F, E, Pf)
        added in place by the lift GEMM, the physical gradient (1/det)
        JGinv^T . tg at the solution points (d, U, F, E): K3, plain torch
        on equation 1)."""
        S, d, U, Pf = self.S, self.ph.d, self.U, self.Pf
        tg.view(d * U, -1).addmm_(S.opp_5_stack.view(d * U, Pf),
                                  delta.reshape(-1, Pf).T)
        grad = (solution_point_gradient_ref if self.ph.scalar
                else solution_point_gradient)
        return tg, grad(tg, S.jg_u, S.inv_det_u.squeeze(1))

    def flux_point_viscous(self, u, uf, tg, with_grad):
        """The element-side viscous (+SGS, + similarity) flux at every flux
        point, projected on the outward normal so that one plane per field
        crosses the face instead of d gradient planes (K3, plain torch on
        equation 1).  Returns the physical gradient at the flux points
        (d, F, E, Pf) when ``with_grad`` (the boundary faces read it), the
        normal flux qn (F, E, Pf), and the similarity flux at the solution
        points (d, U, F, E) or None."""
        ph, S, d = self.ph, self.S, self.ph.d
        tgf = self.to_fpts(tg)                            # (d, F, E, Pf)
        if ph.scalar:
            g_f = [(sum(S.jg_f[m, l] * tgf[m] for m in range(d))
                    * S.inv_det_f) for l in range(d)]     # d x (1, E, Pf)
            fv_e = adv_diff_flux_p([g.unbind(0) for g in g_f],
                                   ph.cfg.diff_coeff)
            qn = torch.stack([sum(fv_e[m][0] * S.norm_f[m]
                                  for m in range(d))])    # (1, E, Pf)
            return g_f, qn, None
        extra = extra_f = None
        if ph.use_similarity:
            up = u.unbind(1)
            Lu, Le = similarity_terms_p(up, self.dg_filter, d)
            extra = torch.stack([torch.stack(r, dim=1) for r in
                                 similarity_flux_p(up, Lu, Le, ph.cfg.gamma,
                                                   d)])   # (d, U, F, E)
            # extrapolated for all dims in one GEMM (ref:src/eles.cpp:2817)
            extra_f = self.to_fpts(extra)
        qn, g_f = flux_point_qn(tgf, uf, S.jg_f, S.inv_det_f, S.norm_f,
                                ph.prm_visc, self.delta_f, self.wdist_f,
                                extra_f, with_grad)
        return g_f, qn, extra

    def volume_call(self, u, gr, extra):
        """The operands of this block's volume stage at the solution
        points, for the grouped launch (volume.volume_tdisf_many)."""
        return VolumeCall(u, gr, self.S.jg_u, self.delta_u, self.wdist_u,
                          extra)

    def over_call(self, u):
        """Over-integration's first volume launch (ref:src/eles.cpp:
        1415-1545): the state interpolated to the cubature points, the
        inviscid flux there (ph.prm_over)."""
        S, U, nF, E = self.S, self.U, self.ph.nF, self.E
        C2 = S.opp_over.shape[0]
        u_o = (S.opp_over @ u.reshape(U, nF * E)).view(C2, nF, E)
        return VolumeCall(u_o, None, S.jg_o, None, None, None)

    def over_back(self, t_o):
        """The cubature points' transformed flux (d, C2, F, E) projected
        back to the solution points (d, U, F, E)."""
        d, nF, E = self.ph.d, self.ph.nF, self.E
        C2 = t_o.shape[1]
        return (self.S.over_filter @ t_o.view(d, C2, nF * E)).view(
            d, self.U, nF, E)

    def visc_call(self, u, gr):
        """Over-integration's second volume launch: the viscous flux at
        the solution points (ph.prm_visc); the JAX branch leaves the
        similarity flux out of the volume term here (residual_soa.py:
        1114-1126)."""
        return VolumeCall(u, gr, self.S.jg_u, self.delta_u, self.wdist_u,
                          None)

    def volume_scalar(self, u, gr):
        """Equation 1's volume transformed flux (d, U, 1, E), plain torch:
        tdisf_l = sum_m adj(J)_lm (a_m u - D du/dx_m) (residual_soa.py:
        1095-1096, 1128-1139 of the JAX package); with over-integration
        the advective part at the cubature points, L2-projected back, and
        the diffusive part at the solution points (:1114-1126)."""
        ph, S, U, d = self.ph, self.S, self.U, self.ph.d
        cfg = ph.cfg

        def transformed(f, jg):
            return torch.stack([sum(jg[l, m][:, None] * f[m]
                                    for m in range(d)) for l in range(d)])
        adv = lambda x: [x * cfg.wave_speed[m] for m in range(d)]
        fv = None
        if cfg.viscous:
            fv = [row[0] for row in adv_diff_flux_p(
                [[g] for g in gr], cfg.diff_coeff)]
        if not cfg.over_int:
            f = adv(u)
            if fv is not None:
                f = [a + b for a, b in zip(f, fv)]
            return transformed(f, S.jg_u)
        C2, E = S.opp_over.shape[0], self.E
        u_o = (S.opp_over @ u.view(U, E)).view(C2, 1, E)
        t_o = transformed(adv(u_o), S.jg_o)                 # (d, C2, 1, E)
        tdisf = (S.over_filter @ t_o.view(d, C2, E)).view(d, U, 1, E)
        if fv is not None:
            tdisf = tdisf + transformed(fv, S.jg_u)
        return tdisf

    def rhs(self, u, gr, ntc, tdisf, out=None):
        """-div / det (+ the SA source) (U, F, E), into ``out`` if given:
        the divergence GEMMs (ref:src/eles.cpp:1654-1772) of the normal
        transformed common flux ``ntc`` (F, E, Pf) and ``tdisf``."""
        ph, S, U = self.ph, self.S, self.U
        d, nF, E = ph.d, ph.nF, self.E
        div = self.lift(S.opp_3, ntc)
        div = div + S.opp_div_fused @ tdisf.view(d * U, nF * E)
        rhs = torch.mul(-div.view(U, nF, E), S.inv_det_u, out=out)
        if ph.cfg.rans:
            # SA source (ref:src/eles.cpp:2650, ref:src/source.cpp:33-105)
            rhs[:, d + 2] += sa_source_p(
                u.unbind(1), [g.unbind(1) for g in gr], S.wdist_u, d,
                **ph.sa_kw)
        return rhs


def make_face_residual(stages, FA: FaceArrays, ph: Physics, bc_fns=None,
                       wm_index=None):
    """residual(us, fluc=None, ramp=None, out=None): the per-block states
    ``us`` (a sequence of (U_t, F, E_t) tensors, one per BlockStages of
    ``stages``) -> their right-hand sides, written into ``out`` if given.
    ``fluc`` (d, *boundary plane), the turbulent inlet's velocity
    fluctuations (turb_inlet.TurbInlet.update), enters the inflow ghost
    states.  ``residual.flux_point_rows(us)`` gives the flux-point rows
    (F, S) of the states, which the inlet reads.

    The face stage runs once on the flux points of all the blocks side by
    side: (C, S) rows with S = sum_t E_t*Pf_t, read and written with the
    flat slot tables ``FA``.  ``bc_fns`` gives the boundary faces' common
    values and ``ramp`` (a 0-d tensor) the BC ramp counter; ``wm_index``
    lists per block the (boundary plane column, element, solution point)
    index tensors of the wall-model input state, or is None.

    On one shard of an element-sharded run (``FA.sharded``) the residual
    is ``residual.stages(us, fluc, ramp, out)``, a generator that stops at
    each halo exchange and at the volume stage.  At the volume stage
    (unless scalar; twice when over-integrated) it yields a
    volume.VolumeRequest of its blocks and takes back their transformed
    fluxes, so that a
    caller can launch the requests of several shards on one card as one
    (volume.volume_tdisf_groups); ``residual(...)`` launches its own.  At
    an exchange it yields the send buffer (C, n_send), the values
    at ``FA.send``, and takes the receive buffer in its place, first of
    the flux-point states and then, viscous, of the element-side normal
    viscous flux qn (soa_sharding.py:473-479, :703-710 of the JAX
    package).  Each shard evaluates a halo face one-sided, with its own
    side as L and its own outward normal, in the same pass as its
    interior faces; the partner's qn carries the partner's outward
    normal, the r-side convention (soa_sharding.py:570-578, :750-765), and
    only the own side is written back.  The similarity flux rides qn, so
    there is no third exchange."""
    cfg, d, nF = ph.cfg, ph.d, ph.nF
    offs = np.cumsum([0] + [k.n_slots for k in stages])
    n_slots = int(offs[-1])
    norm = FA.norm
    if FA.has_bdy:
        norm_b = FA.norm_b

    def flat(xs):
        """Per-block flux-point rows (C, E_t, Pf_t) -> (C, S)."""
        if len(xs) == 1:
            return xs[0].view(xs[0].shape[0], -1)
        return torch.cat([x.view(x.shape[0], -1) for x in xs], dim=1)

    def block_rows(x2, i):
        """Block i's rows (C, E_i, Pf_i) of (C, S) rows, a view."""
        k = stages[i]
        return x2[:, offs[i]:offs[i + 1]].view(-1, k.E, k.Pf)

    def read(x2, slots, shape):
        """(C, S) -> the face planes (C, *shape) at ``slots``."""
        return x2.index_select(1, slots).view(x2.shape[0], *shape)

    def with_partner(x_r, recv):
        """The r planes (C, *shape_r) of the interior faces completed by the
        halo faces' partner side from the receive buffer (C, n_recv)."""
        return torch.cat([x_r, read(recv, FA.recv_idx, FA.shape_h)], dim=-1)

    def write(v_l, v_r, v_b=None):
        """Per-side face values and the boundary faces' values (C, *face
        plane) -> flux-point rows (C, S), the batched inverse of read
        (ref:src/int_inters.cpp:217-220 writes point by point); a halo
        face's r side lives on another shard and is not written."""
        C = v_l.shape[0]
        out = torch.empty((C, n_slots), dtype=v_l.dtype, device=v_l.device)
        out.index_copy_(1, FA.slot_l, v_l.reshape(C, -1))
        out.index_copy_(1, FA.slot_r, v_r[..., :FA.n_r].reshape(C, -1))
        if v_b is not None:
            out.index_copy_(1, FA.slot_b, v_b.reshape(C, -1))
        return out

    def wall_model_state(us):
        """The wall-model input state u[upt, :, ele] of each boundary
        column (residual_soa.py:1213-1222, residual_mixed_soa.py:806-822)
        as F planes shaped as the boundary planes' columns."""
        ws = us[0].new_zeros((nF, FA.n_cols_b))
        for u, (cols, ele, upt) in zip(us, wm_index):
            if cols is not None:
                ws.index_copy_(1, cols, u[upt, :, ele].T)
        return ws.view(nF, *(1,) * (len(FA.shape_b) - 1), -1).unbind(0)

    def face_states(us):
        """Steps 1-2: the per-block flux-point rows (F, E_t, Pf_t) and
        side by side (F, S), and the interior faces' two sides (F, *face
        plane)."""
        # 1. extrapolate to flux points: one GEMM per block
        ufs = [k.to_fpts(u) for k, u in zip(stages, us)]  # (F, E_t, Pf_t)
        uf2 = flat(ufs)
        # 2. all interior faces at once
        u_l = read(uf2, FA.slot_l, FA.shape_i)            # (F, *face plane)
        u_r = read(uf2, FA.slot_r, FA.shape_r)
        return ufs, uf2, u_l, u_r

    def boundary_states(uf2, ramp, fluc=None):
        """The boundary faces' side of steps 2-3, from the flux-point rows
        (F, S): their own states, their inviscid ghost states (bc.py; JAX
        reads them from the same extrapolation, residual_soa.py:
        1042-1047) and, viscous, their LDG common solution
        (residual_soa.py:1068-1071) and its jump (F, *boundary plane)
        (F planes each, the jump stacked; None inviscid).  The inlet's
        ``fluc`` enters the ghost states once, here: the LDG common
        solution and the boundary viscous flux reuse them away from walls
        (bc.BCFunctions.ldg_solution), as the JAX closures rebuild them
        with the same fluc (bc.py:327-357)."""
        u_b = read(uf2, FA.slot_b, FA.shape_b).unbind(0)
        g0_b = bc_fns.ghost_state(u_b, norm_b, 0, ramp, fluc=fluc)
        u_c_b = delta_b = None
        if cfg.viscous:
            u_c_b = bc_fns.ldg_solution(u_b, norm_b, g0_b, ramp)
            delta_b = torch.stack([c - a for c, a in zip(u_c_b, u_b)])
        return u_b, g0_b, u_c_b, delta_b

    def corrected_gradient(us, u_l, u_r, delta_b):
        """Step 3's gradient: the LDG common solution on every interior
        face, its jumps written with the boundary faces' ``delta_b`` (or
        None), and per block the transformed gradient with its face lift
        and the physical gradient (d, U, F, E) (BlockStages.gradient).
        Returns the per-block (tg, gr)."""
        bcoef = cfg.ldg_beta * ldg_sign_p(norm)
        u_c = 0.5 * (u_l + u_r) - bcoef * (u_l - u_r)
        delta = write(u_c - u_l, u_c - u_r, delta_b)
        return [k.gradient(k.tgrad(u), block_rows(delta, i))
                for i, (k, u) in enumerate(zip(stages, us))]

    def boundary_flux(us, bdy, g_fs):
        """The boundary common flux (F, *boundary plane)
        (residual_soa.py:1198-1226): Riemann against the ghost state plus,
        viscous, the boundary viscous flux from the physical gradient at
        the boundary flux points, read from the per-block flux-point
        gradients ``g_fs`` (JAX: adjT_apply on the boundary rows,
        residual_soa.py:1211); it carries no SGS term (bc.py:413-417)."""
        u_b, g0_b, u_c_b, _ = bdy
        fn_b = bc_fns.inv_common_flux(u_b, norm_b, g0_b)
        if cfg.viscous:
            g_b = [read(flat([g[l] for g in g_fs]), FA.slot_b,
                        FA.shape_b).unbind(0) for l in range(d)]
            wm_state = None if wm_index is None else wall_model_state(us)
            fv_b = bc_fns.visc_common_flux(u_b, g_b, norm_b, u_c_b,
                                           wm_state)
            fn_b = [a + b for a, b in zip(fn_b, fv_b)]
        return torch.stack(fn_b)

    def gradient(us, ramp=None):
        """The LDG-corrected physical gradient (d, U_t, F, E_t) of each
        block's state: what the viscous residual computes at step 3
        (residual.py:508-547 of the JAX package, make_gradient_fn)."""
        _, uf2, u_l, u_r = face_states(us)
        delta_b = boundary_states(uf2, ramp)[3] if FA.has_bdy else None
        return [gr for _, gr in corrected_gradient(us, u_l, u_r, delta_b)]

    def stages_of(us, fluc=None, ramp=None, out=None):
        part = tracing.part
        with part("residual.face_states"):
            ufs, uf2, u_l, u_r = face_states(us)
            if FA.sharded:
                send = uf2.index_select(1, FA.send)
        bdy = None
        if FA.has_bdy:
            with part("residual.boundary"):
                bdy = boundary_states(uf2, ramp, fluc)
        if FA.sharded:
            # the solution exchange (ref:src/mpi_inters.cpp:218-276)
            recv = yield send
            with part("residual.face_states"):
                u_r = with_partner(u_r, recv)

        # 3. viscous gradient path
        grs = extras = [None] * len(stages)
        g_fs = qn_l = qn_r = None
        if cfg.viscous:
            with part("residual.gradient"):
                grads = corrected_gradient(
                    us, u_l, u_r, None if bdy is None else bdy[3])
                grs, extras, g_fs, qns = [], [], [], []
                for k, u, uf, (tg, gr) in zip(stages, us, ufs, grads):
                    g_f, qn, extra = k.flux_point_viscous(u, uf, tg,
                                                          FA.has_bdy)
                    grs.append(gr)
                    extras.append(extra)
                    g_fs.append(g_f)
                    qns.append(qn)
                qn2 = flat(qns)
                qn_l = read(qn2, FA.slot_l, FA.shape_i)
                qn_r = read(qn2, FA.slot_r, FA.shape_r)
                if FA.sharded:
                    send = qn2.index_select(1, FA.send)
            if FA.sharded:
                # the qn exchange (ref:src/mpi_inters.cpp:278-338 ships
                # the gradient; qn is F planes instead of d*F)
                recv = yield send
                with part("residual.gradient"):
                    qn_r = with_partner(qn_r, recv)

        # 4. volume transformed flux: the hand kernel, one grouped launch
        # for every block (and shard) of the card; over-integrated, two
        # (the inviscid flux at the cubature points, a GEMM back, then
        # the viscous flux at the solution points)
        if ph.scalar:
            with part("residual.volume"):
                tdisfs = [k.volume_scalar(u, gr)
                          for k, u, gr in zip(stages, us, grs)]
        elif cfg.over_int:
            with part("residual.volume"):
                req = VolumeRequest([k.over_call(u)
                                     for k, u in zip(stages, us)],
                                    ph.prm_over)
            t_os = yield req
            with part("residual.volume"):
                tdisfs = [k.over_back(t_o) for k, t_o in zip(stages, t_os)]
            if cfg.viscous:
                t_vs = yield VolumeRequest(
                    [k.visc_call(u, gr) for k, u, gr in zip(stages, us, grs)],
                    ph.prm_visc)
                with part("residual.volume"):
                    tdisfs = [a + b for a, b in zip(tdisfs, t_vs)]
        else:
            tdisfs = yield VolumeRequest(
                [k.volume_call(u, gr, extra)
                 for k, u, gr, extra in zip(stages, us, grs, extras)],
                ph.prm)

        # 5. common interface flux (Riemann + LDG), all interior faces at
        # once, written back to their element flux points: fn at the l
        # side, -fn at the r side (K4)
        with part("residual.common_flux"):
            ntc = common_flux(u_l, u_r, qn_l, qn_r, FA.norm_t, FA.slot_l,
                              FA.slot_r, n_slots, cfg)
        fn_b = None
        if FA.has_bdy:
            with part("residual.boundary"):
                fn_b = boundary_flux(us, bdy, g_fs)
        # 6. the boundary faces' write-back + tdA scaling, 7. divergence
        with part("residual.divergence"):
            if fn_b is not None:
                ntc.index_copy_(1, FA.slot_b, fn_b.reshape(nF, -1))
            outs = [None] * len(stages) if out is None else out
            return tuple(k.rhs(u, gr, block_rows(ntc, i) * k.S.tdA, tdisf,
                               o)
                         for i, (k, u, gr, tdisf, o) in enumerate(
                             zip(stages, us, grs, tdisfs, outs)))

    def residual(us, fluc=None, ramp=None, out=None):
        gen = stages_of(us, fluc, ramp, out)
        try:
            msg = next(gen)
            while isinstance(msg, VolumeRequest):
                with tracing.part("residual.volume"):
                    t = volume_tdisf_many(msg.calls, msg.prm)
                msg = gen.send(t)
        except StopIteration as done:
            return done.value
        raise RuntimeError("hifiles_tpu_torch residual: halo faces; run "
                           "the shards through residual.stages")

    residual.stages = stages_of
    residual.gradient = gradient
    residual.flux_point_rows = lambda us: flat(
        [k.to_fpts(u) for k, u in zip(stages, us)])
    return residual


def block_wm_index(bc_fns):
    """make_face_residual's ``wm_index`` for one block whose boundary
    plane columns are its boundary faces (bc.make_bc_functions): every
    column's element and solution point; None without wall models."""
    if bc_fns is None or bc_fns.wm_tables is None:
        return None
    wm_ele, wm_upt, _ = bc_fns.wm_tables
    return [(torch.arange(wm_ele.numel(), device=wm_ele.device), wm_ele,
             wm_upt)]


def make_residual_soa(block: ElementBlock, cfg: ResidualConfig, device,
                      dtype, bc_fns=None):
    """Build residual_soa(u, fluc=None, ramp=None) with u (U, F, E) ->
    rhs (U, F, E) on ``device`` for one single-type block; ``bc_fns``
    (bc.make_bc_functions) gives the boundary faces' common values and
    ``ramp`` (a 0-d tensor) the BC ramp counter.  Raises
    NotImplementedError for configurations the port does not cover yet."""
    missing = unsupported(block, cfg, bc_fns)
    if missing:
        raise NotImplementedError("hifiles_tpu_torch residual: not ported "
                                  "yet: " + ", ".join(missing))
    ph = Physics(cfg, block.ops.n_dims)
    FA = FaceArrays(SoaTables(block), device, dtype)
    residual = make_face_residual([BlockStages(block, ph, device, dtype)],
                                  FA, ph, bc_fns, block_wm_index(bc_fns))

    def residual_soa(u, fluc=None, ramp=None):
        return residual((u,), fluc, ramp)[0]

    residual_soa.gradient = lambda u, ramp=None: residual.gradient((u,),
                                                                   ramp)[0]
    residual_soa.flux_point_rows = lambda u: residual.flux_point_rows((u,))
    return residual_soa
