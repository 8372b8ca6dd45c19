"""Boundary conditions on planes: ghost states, common fluxes and boundary
gradients for the Navier-Stokes BC kinds (ref:src/bdy_inters.cpp:340-1019
set_boundary_conditions, :1138-1188 set_boundary_gradients).

Port of hifiles_tpu/solver/bc.py::make_bc_functions (:76-445).  The residual
passes the state at the boundary flux points as F planes and the outward
normals as d planes; the per-group parameters are planes (1, Fb) with one
column per plane column, which broadcast over the plane's rows.  On one
block the planes are (nfp, Fb), a column per face; on a mixed mesh, whose
boundary faces differ in their point counts, they are (1, Nb), a column
per boundary point, each point carrying its face's group and wall-model
distance.  As in the JAX
package, a candidate ghost state is evaluated for every flag present on the
block and the candidates are combined with masks; a flag that covers every
boundary column takes its candidate without a mask.

Unlike the JAX closures, which each rebuild the ghost states they need, the
functions here take the sol_spec 0 ghost state and the LDG common solution
from the caller, so the residual computes each once per stage (the numbers
are the same).  The turbulent inlet's fluctuations (``fluc``), AD_WALL and
advection-diffusion are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.params import (AD_WALL, ADIABAT_WALL, CHAR, ISOTHERM_WALL,
                             SLIP_WALL, SLIP_WALL_DUAL, SUB_IN_CHAR,
                             SUB_IN_SIMP, SUB_OUT_CHAR, SUB_OUT_SIMP, SUP_IN,
                             SUP_OUT, RunInput)

from ..models.wall_model import wall_stress_flux
from .residual_soa import (HLLC, ROEM, RUSANOV, _normal_flux_p, hllc_p,
                           roem_p, rusanov_p)
from .volume import visc_flux_p

WALL_FLAGS = (SLIP_WALL, ISOTHERM_WALL, ADIABAT_WALL, AD_WALL,
              SLIP_WALL_DUAL)
# flags whose boundary gradient is zero (ref:src/bdy_inters.cpp:1138-1188)
ZERO_GRAD_FLAGS = (CHAR, SUP_IN, SUB_IN_SIMP, SUB_OUT_SIMP)
INFLOW_FLAGS = (SUB_IN_SIMP, SUB_IN_CHAR, SUP_IN)


def _pack_params(run_input: RunInput, bcid: np.ndarray, n_dims: int):
    """Per-boundary-point parameter arrays gathered by group id
    (bc.py:49-73 of the JAX package)."""
    bcs = run_input.bc_list

    def arr(get):
        return np.array([get(b) for b in bcs], dtype=np.float64)[bcid]
    return {
        "flag": np.array([b.flag for b in bcs], dtype=np.int64)[bcid],
        "rho": arr(lambda b: b.rho),
        "vel": np.stack([arr(lambda b, i=i: b.velocity[i])
                         for i in range(n_dims)], axis=-1),
        "p_static": arr(lambda b: b.p_static),
        "T_static": arr(lambda b: b.T_static),
        "p_total": arr(lambda b: b.p_total),
        "T_total": arr(lambda b: b.T_total),
        "nfs": np.stack([arr(lambda b, i=i: (b.nx, b.ny, b.nz)[i])
                         for i in range(n_dims)], axis=-1),
        "use_wm": arr(lambda b: b.use_wm),
        # pressure/temperature ramping (ref:src/bdy_inters.cpp:482-509)
        "pressure_ramp": arr(lambda b: b.pressure_ramp),
        "p_ramp_coeff": arr(lambda b: b.p_ramp_coeff),
        "T_ramp_coeff": arr(lambda b: b.T_ramp_coeff),
        "p_total_old": arr(lambda b: b.p_total_old),
        "T_total_old": arr(lambda b: b.T_total_old),
    }


def build_wm_tables(block, use_wm_face: np.ndarray):
    """Wall-model input points (bc.py:452-479 of the JAX package): per
    wall-modelled boundary face, the solution point of the face's element
    with the largest min-distance to the face (ref:src/eles.cpp:4873-4903
    calc_wm_upts_dist).  Returns (wm_ele, wm_upt, wm_dist) over the block's
    boundary faces; faces without a wall model get (0, 0, 1)."""
    Pf = block.ops.n_fpts
    Fb = block.bdy_bcid.size
    wm_ele = np.zeros(Fb, dtype=np.int64)
    wm_upt = np.zeros(Fb, dtype=np.int64)
    wm_dist = np.ones(Fb)
    for fi in range(Fb):
        if use_wm_face[fi] <= 0:
            continue
        slots = block.bdy_slot[fi][block.bdy_mask[fi] > 0]
        e = int(slots[0] // Pf)
        fpt_pos = block.pos_fpts[slots]           # (nfp, d)
        fpt_nrm = block.norm_fpts[slots]
        # distance of each upt: min over face fpts of (x_f - x_u).n
        dvec = fpt_pos[None, :, :] - block.pos_upts[e][:, None, :]
        dist = np.einsum("ufd,fd->uf", dvec, fpt_nrm).min(axis=1)
        wm_upt[fi] = int(np.argmax(dist))
        wm_dist[fi] = float(dist.max())
        wm_ele[fi] = e
    return wm_ele, wm_upt, wm_dist


def not_ported(run_input: RunInput, flags) -> list:
    """Boundary features of ``run_input`` this port does not cover yet, for
    the BC flags present on a block."""
    missing = []
    if run_input.equation == 1 or AD_WALL in flags:
        missing.append("AD_WALL and advection-diffusion (equation 1)")
    if run_input.LES and any(b.flag in INFLOW_FLAGS and b.inlet_type != 0
                             for b in run_input.bc_list):
        # the condition of turb_inlet.inlet_host_setup (turb_inlet.py:70)
        missing.append("turbulent inlets (inlet_type > 0)")
    return missing


class BCFunctions:
    """The boundary side of the face stage.

    ``bcid`` gives the group of each plane column (a face of a block, or a
    boundary point of a mixed mesh).  Every method takes and returns lists
    of planes.  ``wm_tables`` holds (wm_ele, wm_upt) index tensors and the
    wm_dist plane (1, Fb) per column when wall models are active, else
    None; it is built from the numpy (wm_ele, wm_upt, wm_dist) given."""

    def __init__(self, run_input: RunInput, bcid, n_dims, rcfg, device,
                 dtype, wm_tables=None):
        self.d = d = n_dims
        self.rcfg = rcfg
        self.gamma = rcfg.gamma
        P = _pack_params(run_input, bcid, d)
        self.flags = sorted(set(int(f) for f in np.unique(P["flag"])))
        self.missing = not_ported(run_input, self.flags)
        plane = lambda a: torch.as_tensor(np.asarray(a)[None, :],
                                          dtype=dtype, device=device)
        self.P = {k: ([plane(v[:, m]) for m in range(d)] if v.ndim == 2
                      else plane(v)) for k, v in P.items() if k != "flag"}
        flag = P["flag"]
        # flag masks (1, Fb); None where the flag covers every face
        self._mask = {f: (None if np.all(flag == f) else
                          torch.as_tensor((flag == f)[None, :],
                                          device=device))
                      for f in self.flags}

        def mask_of(sel):
            if not sel.any() or sel.all():
                return bool(sel.all())
            return torch.as_tensor(sel[None, :], device=device)
        # True / False when uniform over the faces, else a (1, Fb) mask
        self._is_wall = mask_of(np.isin(flag, WALL_FLAGS))
        self._zero_grad = mask_of(np.isin(flag, ZERO_GRAD_FLAGS))
        self._use_wm = mask_of(P["use_wm"] > 0)
        self.wall_flags = [f for f in self.flags if f in WALL_FLAGS]
        # inviscid runs use the dimensional gas constant
        # (ref:src/bdy_inters.cpp:368-371)
        R_ref = run_input.R_gas if not rcfg.viscous else run_input.R_ref
        self.R_ref = run_input.R_gas if np.isnan(R_ref) else R_ref
        self.mu_tilde_inf = run_input.mu_tilde_inf
        self.has_ramp = any(getattr(b, "pressure_ramp", 0)
                            for b in run_input.bc_list)
        self.riemann = {RUSANOV: rusanov_p, ROEM: roem_p,
                        HLLC: hllc_p}.get(rcfg.riemann_solve_type)
        # the boundary viscous flux carries no SA constants beyond the
        # defaults and no SGS term (bc.py:413-417 of the JAX package)
        self.visc_kw = dict(gamma=rcfg.gamma, prandtl=rcfg.prandtl,
                            mu_inf=rcfg.mu_inf, rt_inf=rcfg.rt_inf,
                            c_sth=rcfg.c_sth, fix_vis=rcfg.fix_vis,
                            rans=rcfg.rans, prandtl_t=rcfg.prandtl_t)
        self.wall_model = run_input.wall_model
        self.wm_tables = None
        self.wm_flags = []
        if wall_models_on(run_input, bcid):
            wm_ele, wm_upt, wm_dist = wm_tables
            self.wm_tables = (torch.as_tensor(wm_ele, device=device),
                              torch.as_tensor(wm_upt, device=device),
                              plane(wm_dist))
            self.wm_flags = sorted(set(int(f) for f in
                                       np.unique(flag[P["use_wm"] > 0])))

    # ------------------------------------------------------------------
    @staticmethod
    def _where(mask, a, b):
        """Plane lists combined point by point: ``a`` where ``mask``; the
        mask is True, False or a (1, Fb) tensor."""
        if mask is True:
            return list(a)
        if mask is False:
            return list(b)
        return [torch.where(mask, x, y) for x, y in zip(a, b)]

    def _pack(self, rho, v, e, u_l):
        return [rho] + [rho * vm for vm in v] + [e] + list(u_l[self.d + 2:])

    def _energy(self, rho, v, p):
        return p / (self.gamma - 1.0) + 0.5 * rho * sum(vm * vm for vm in v)

    def ghost_state(self, u_l, norm, sol_spec, ramp=None, flags=None):
        """Vectorised set_boundary_conditions (bc.py:121-321 of the JAX
        package; ref:src/bdy_inters.cpp:340-1019) for the flags ``flags``
        (default: every flag on the block); points of other flags keep
        u_l.  ``ramp``: the iteration counter for SUB_IN_CHAR ramping
        (ref::482-509), a 0-d tensor, or None."""
        d, g, P, R_ref = self.d, self.gamma, self.P, self.R_ref
        rans = self.rcfg.rans
        rho_l = u_l[0]
        v_l = [u_l[1 + m] / rho_l for m in range(d)]
        vsq_l = sum(vm * vm for vm in v_l)
        p_l = (g - 1.0) * (u_l[d + 1] - 0.5 * rho_l * vsq_l)
        e_l = u_l[d + 1]
        vn_l = sum(v_l[m] * norm[m] for m in range(d))
        c_l = torch.sqrt(g * p_l / rho_l)
        sa_const = lambda val: torch.full_like(rho_l, val)
        u_r = list(u_l)              # default: extrapolate (SUP_OUT)

        for f in (self.flags if flags is None else flags):
            if f == SUB_IN_SIMP:
                # fixed rho & velocity, free pressure
                # (ref:src/bdy_inters.cpp:374-395)
                rho_r, v_r = P["rho"], P["vel"]
                cand = self._pack(rho_r, v_r, self._energy(rho_r, v_r, p_l),
                                  u_l)
                if rans:
                    cand[d + 2] = sa_const(self.mu_tilde_inf)
            elif f == SUB_OUT_SIMP:
                # FUN3D-style fixed back pressure with reverse-flow guard
                # (ref:src/bdy_inters.cpp:399-464)
                machn_l = torch.abs(vn_l) / c_l
                v_rev = [vn_l * norm[m] for m in range(d)]
                vsq_rev = vn_l * vn_l
                T_rev = P["T_total"] - 0.5 * vsq_rev * (g - 1.0) \
                    / (R_ref * g)
                p_rev = P["p_static"] * (
                    1.0 + 0.5 * (g - 1.0) * vsq_rev / (g * R_ref * T_rev)
                ) ** (-g / (g - 1.0))
                rho_rev = p_rev / (R_ref * T_rev)
                cand_rev = self._pack(rho_rev, v_rev,
                                      self._energy(rho_rev, v_rev, p_rev),
                                      u_l)
                cand_sub = self._pack(rho_l, v_l,
                                      self._energy(rho_l, v_l,
                                                   P["p_static"]), u_l)
                cand = self._where(vn_l < 0, cand_rev,
                                   self._where(machn_l >= 1, u_l, cand_sub))
            elif f == SUB_IN_CHAR:
                # SU2-style total-state inflow (ref:src/bdy_inters.cpp:
                # 471-585)
                p_tot, T_tot = P["p_total"], P["T_total"]
                if self.has_ramp and ramp is not None:
                    # linear ramp toward the target totals, capped at the
                    # target; T_ramp_coeff < 0 = isentropic relation from
                    # the local state (ref:src/bdy_inters.cpp:482-509)
                    on = P["pressure_ramp"] > 0
                    p_r = torch.minimum(
                        p_tot, P["p_total_old"]
                        + (p_tot - P["p_total_old"])
                        * P["p_ramp_coeff"] * ramp)
                    p_tot = torch.where(on & (P["p_ramp_coeff"] > 0), p_r,
                                        p_tot)
                    T_lin = torch.minimum(
                        T_tot, P["T_total_old"]
                        + (T_tot - P["T_total_old"])
                        * P["T_ramp_coeff"] * ramp)
                    T_l = p_l / (rho_l * R_ref)
                    T_isen = T_l * (p_tot / p_l) ** ((g - 1.0) / g)
                    T_tot = torch.where(
                        on & (P["T_ramp_coeff"] > 0), T_lin,
                        torch.where(on & (P["T_ramp_coeff"] < 0), T_isen,
                                    T_tot))
                R_plus = vn_l + 2.0 * c_l / (g - 1.0)
                c_tot_sq = g * R_ref * T_tot
                alpha = sum(norm[m] * P["nfs"][m] for m in range(d))
                aa = 1.0 + 0.5 * (g - 1.0) * alpha * alpha
                bb = -(g - 1.0) * alpha * R_plus
                cc = (0.5 * (g - 1.0) * R_plus * R_plus
                      - 2.0 * c_tot_sq / (g - 1.0))
                dd = torch.sqrt(torch.clamp(bb * bb - 4.0 * aa * cc,
                                            min=0.0))
                V_r = torch.clamp((-bb + dd) / (2.0 * aa), min=0.0)
                vsq = V_r * V_r
                c_r_sq = c_tot_sq - 0.5 * (g - 1.0) * vsq
                Mach_sq = torch.clamp(vsq / c_r_sq, max=1.0)
                vsq = Mach_sq * c_r_sq
                V_r = torch.sqrt(vsq)
                c_r_sq = c_tot_sq - 0.5 * (g - 1.0) * vsq
                v_r = [V_r * P["nfs"][m] for m in range(d)]
                T_r = c_r_sq / (g * R_ref)
                p_r = p_tot * (T_r / T_tot) ** (g / (g - 1.0))
                rho_r = p_r / (R_ref * T_r)
                cand = self._pack(rho_r, v_r, self._energy(rho_r, v_r, p_r),
                                  u_l)
                if rans:
                    cand[d + 2] = sa_const(self.mu_tilde_inf)
            elif f == SUB_OUT_CHAR:
                # characteristic outflow (ref:src/bdy_inters.cpp:593-641)
                R_plus = vn_l + 2.0 * c_l / (g - 1.0)
                s = p_l / rho_l**g
                p_r = P["p_static"]
                rho_r = (p_r / s) ** (1.0 / g)
                c_r = torch.sqrt(g * p_r / rho_r)
                vn_r = R_plus - 2.0 * c_r / (g - 1.0)
                v_r = [v_l[m] + (vn_r - vn_l) * norm[m] for m in range(d)]
                cand = self._pack(rho_r, v_r, self._energy(rho_r, v_r, p_r),
                                  u_l)
            elif f == SUP_IN:
                rho_r, v_r, p_r = P["rho"], P["vel"], P["p_static"]
                cand = self._pack(rho_r, v_r, self._energy(rho_r, v_r, p_r),
                                  u_l)
            elif f == SUP_OUT:
                cand = list(u_l)
            elif f in (SLIP_WALL, SLIP_WALL_DUAL):
                # (ref:src/bdy_inters.cpp:674-702, 976-994)
                fac = 2.0 if (sol_spec == 0 or f == SLIP_WALL_DUAL) else 1.0
                v_r = [v_l[m] - fac * vn_l * norm[m] for m in range(d)]
                e_r = (e_l if f == SLIP_WALL_DUAL
                       else self._energy(rho_l, v_r, p_l))
                cand = self._pack(rho_l, v_r, e_r, u_l)
            elif f in (ISOTHERM_WALL, ADIABAT_WALL):
                # (ref:src/bdy_inters.cpp:705-863).  With a wall model the
                # inviscid/LDG states use slip logic (sol_spec 0/1) and the
                # no-slip wall state is sol_spec 2 (ref::713-762, :802-830)
                vel = P["vel"]
                if sol_spec == 0:
                    v_plain = [2.0 * vel[m] - v_l[m] for m in range(d)]
                    v_wm = [v_l[m] - 2.0 * vn_l * norm[m] for m in range(d)]
                elif sol_spec == 1:
                    v_plain = list(vel)
                    v_wm = [v_l[m] - vn_l * norm[m] for m in range(d)]
                else:
                    v_plain = v_wm = list(vel)
                v_r = self._where(self._use_wm, v_wm, v_plain)
                if f == ISOTHERM_WALL:
                    # wall-temperature energy, except wm slip states
                    # extrapolate temperature (ref::726-731, :744-749)
                    e_iso = rho_l * (R_ref / (g - 1.0) * P["T_static"]) \
                        + 0.5 * rho_l * sum(vm * vm for vm in v_r)
                    use_ext = self._use_wm if sol_spec in (0, 1) else False
                    e_r = self._where(use_ext,
                                      [self._energy(rho_l, v_r, p_l)],
                                      [e_iso])[0]
                else:
                    e_r = self._energy(rho_l, v_r, p_l)
                cand = self._pack(rho_l, v_r, e_r, u_l)
                if rans:
                    cand[d + 2] = sa_const(0.0)
            elif f == CHAR:
                # far-field Riemann (ref:src/bdy_inters.cpp:867-973)
                vel = P["vel"]
                vn_r = sum(vel[m] * norm[m] for m in range(d))
                c_r = torch.sqrt(g * P["p_static"] / P["rho"])
                mach = torch.abs(vn_l) / c_l
                inflow = vn_l < 0
                sup = mach >= 1.0
                r_plus = torch.where(
                    inflow & sup, vn_r + 2.0 / (g - 1.0) * c_r,
                    vn_l + 2.0 / (g - 1.0) * c_l)
                r_minus = torch.where(
                    ~inflow & sup, vn_l - 2.0 / (g - 1.0) * c_l,
                    vn_r - 2.0 / (g - 1.0) * c_r)
                c_star = 0.25 * (g - 1.0) * (r_plus - r_minus)
                vn_star = 0.5 * (r_plus + r_minus)
                one_over_s = torch.where(inflow, P["rho"]**g / P["p_static"],
                                         rho_l**g / p_l)
                rho_r = (one_over_s * c_star * c_star / g) \
                    ** (1.0 / (g - 1.0))
                v_r = [vn_star * norm[m] + torch.where(
                    inflow, vel[m] - vn_r * norm[m],
                    v_l[m] - vn_l * norm[m]) for m in range(d)]
                p_r = rho_r / g * c_star * c_star
                cand = self._pack(rho_r, v_r, self._energy(rho_r, v_r, p_r),
                                  u_l)
                if rans:
                    cand[d + 2] = torch.where(inflow, self.mu_tilde_inf,
                                              u_l[d + 2])
            else:
                raise NotImplementedError(
                    f"hifiles_tpu_torch BC flag {f} not ported yet "
                    "(AD_WALL comes with advection-diffusion)")
            mask = self._mask[f]
            u_r = self._where(True if mask is None else mask, cand, u_r)
        return u_r

    # ------------------------------------------------------------------
    def inv_common_flux(self, u_l, norm, u_r0):
        """Riemann flux against the sol_spec 0 ghost state ``u_r0``
        (ref:src/bdy_inters.cpp:230-307); dual-consistent slip walls take
        the left state's own normal flux."""
        fn = self.riemann(u_l, u_r0, norm, self.gamma, self.d)
        if SLIP_WALL_DUAL in self.flags:
            fn_l = _normal_flux_p(u_l, norm, self.d, self.gamma)
            mask = self._mask[SLIP_WALL_DUAL]
            fn = self._where(True if mask is None else mask, fn_l, fn)
        return fn

    def ldg_solution(self, u_l, norm, u_r0, ramp=None):
        """Boundary LDG common solution: the sol_spec 1 state on walls,
        the inviscid ghost ``u_r0`` elsewhere (ref:src/bdy_inters.cpp:
        309-324, ref:src/inters.cpp:640-643)."""
        if not self.wall_flags:
            return list(u_r0)
        u_r1 = self.ghost_state(u_l, norm, 1, ramp, flags=self.wall_flags)
        return self._where(self._is_wall, u_r1, u_r0)

    def boundary_gradients(self, u_r, grad_l, norm):
        """Boundary gradient planes [d][F] (ref:src/bdy_inters.cpp:
        1138-1188): zero on CHAR/SUP_IN/SUB_IN_SIMP/SUB_OUT_SIMP, the
        wall-normal internal-energy gradient removed on adiabatic walls."""
        d = self.d
        grad_r = [list(g) for g in grad_l]
        if self._zero_grad is not False:
            zero = [torch.zeros_like(x) for x in grad_r[0]]
            grad_r = [self._where(self._zero_grad, zero, g) for g in grad_r]
        if ADIABAT_WALL in self.flags:
            rho = u_r[0]
            mom = u_r[1:1 + d]
            vsq = sum(m_ * m_ for m_ in mom)
            inte = (u_r[d + 1] - 0.5 * vsq / rho) / rho
            grad_rho = [grad_r[j][0] for j in range(d)]
            grad_vel = [[(grad_r[j][1 + i] - grad_rho[j] * (mom[i] / rho))
                         / rho for j in range(d)] for i in range(d)]
            gE = [grad_r[j][d + 1] for j in range(d)]
            grad_inte = [gE[j] - (inte * grad_rho[j]
                                  + 0.5 * (vsq / rho**2) * grad_rho[j]
                                  + sum(mom[i] * grad_vel[i][j]
                                        for i in range(d)))
                         for j in range(d)]
            gn = sum(grad_inte[j] * norm[j] for j in range(d))
            mask = self._mask[ADIABAT_WALL]
            fix = self._where(True if mask is None else mask,
                              [gE[j] - gn * norm[j] for j in range(d)], gE)
            for j in range(d):
                grad_r[j][d + 1] = fix[j]
        return grad_r

    def visc_common_flux(self, u_l, grad_l, norm, u_c, wm_state=None):
        """Boundary viscous common flux f(u_c, grad_r) . n - tau (u_c - u_l)
        (ref:src/bdy_inters.cpp:1029-1093) with the LDG common solution
        ``u_c``; zero on slip walls; the modelled wall stress where a wall
        model is on (ref::1095-1131), from ``wm_state``: F planes (1, Fb)
        of the wall-model input state."""
        d, rcfg = self.d, self.rcfg
        grad_r = self.boundary_gradients(u_c, grad_l, norm)
        f_r = visc_flux_p(u_c, grad_r, d, **self.visc_kw)
        fn = [sum(f_r[m][i] * norm[m] for m in range(d))
              - rcfg.ldg_tau * (u_c[i] - u_l[i]) for i in range(len(u_l))]
        if SLIP_WALL in self.flags:
            mask = self._mask[SLIP_WALL]
            fn = self._where(True if mask is None else mask,
                             [torch.zeros_like(x) for x in fn], fn)
        if self.wm_tables is not None:
            u_w = self.ghost_state(u_l, norm, 2, flags=self.wm_flags)
            fn_wm = wall_stress_flux(
                wm_state, u_w, self.wm_tables[2], norm,
                wall_model=self.wall_model, gamma=self.gamma,
                prandtl=rcfg.prandtl, prandtl_t=rcfg.prandtl_t,
                mu_inf=rcfg.mu_inf, rt_inf=rcfg.rt_inf, c_sth=rcfg.c_sth,
                fix_vis=rcfg.fix_vis, kappa=rcfg.kappa, n_dims=d)
            fn = self._where(self._use_wm, fn_wm, fn)
        return fn


def use_wm_of(run_input: RunInput, bcid) -> np.ndarray:
    """The use_wm flag of each boundary column's group."""
    return np.array([b.use_wm for b in run_input.bc_list],
                    dtype=np.float64)[np.asarray(bcid)]


def wall_models_on(run_input: RunInput, bcid) -> bool:
    """Whether a wall model runs on any of the boundary columns ``bcid``
    (bc.py:390-391 of the JAX package)."""
    return bool(run_input.wall_model > 0 and len(bcid)
                and np.any(use_wm_of(run_input, bcid) > 0))


def make_bc_functions(run_input: RunInput, block, rcfg, device,
                      dtype) -> BCFunctions:
    """The boundary functions of one element block on ``device``: a plane
    column per boundary face."""
    bcid = block.bdy_bcid
    wm = None
    if wall_models_on(run_input, bcid):
        wm = build_wm_tables(block, use_wm_of(run_input, bcid))
    return BCFunctions(run_input, bcid, block.ops.n_dims, rcfg, device,
                       dtype, wm)
