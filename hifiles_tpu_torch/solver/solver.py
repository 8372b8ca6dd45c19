"""Solver orchestration: config + mesh -> time stepping on a torch device.

Port of hifiles_tpu/solver/solver.py (:32-276) for one quad, tri, hex or
tet block: the "SoA (fast)" chunk and the "SoA featured (fast)" chunk
(solver.py:380-482), i.e. the
features of the SoA residual port with boundary conditions and wall models,
the SVV pre-step filter, shock capture, the BC ramp counter, bulk-momentum
body forcing and running time averages; fixed dt.  Setup runs once on the
host in numpy; the time loop is a Python loop of RK steps on the
elements-minor (U, F, E) state.  The featured carry (ramp counter, mass-flux
memory, simulated time, averages) stays in device tensors of the state's
dtype, as the JAX scan carry does, so a step never waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import CTYPE_NAMES, HEX, PRISM, QUAD, TET, TRI
from ..config.params import ADIABAT_WALL, CYCLIC, ISOTHERM_WALL, RunInput
from ..mesh.core import NUM_F_PER_C, MeshData, build_faces
from ..ops.les_filter import build_les_filter
from ..ops.operators import build_tensor_ops, build_tet_ops, build_tri_ops

from ..backend import select_device
from ..convert import euf_to_ufe, state_from_numpy, ufe_to_euf
from ..ops.stabilization import make_shock_capture_soa
from .bc import make_bc_functions, not_ported
from .elements import build_element_block
from .ics import analytic_solution, apply_patch, initial_condition
from .residual import ResidualConfig
from .residual_soa import make_residual_soa
from .step import N_STAGES, make_step_fn


AVERAGE_FIELDS = ("rho_average", "u_average", "v_average", "w_average",
                  "e_average")


def _unsupported(p: RunInput, mesh: MeshData) -> list:
    """Solver features this port does not cover yet (the residual's own
    are reported by residual_soa.unsupported)."""
    missing = []
    types = np.unique(mesh.ctype)
    if types.size > 1:
        missing.append("mixed element types ("
                       + ", ".join(CTYPE_NAMES[int(t)] for t in types)
                       + "; MixedSolver)")
    elif int(types[0]) == PRISM:
        missing.append("prism blocks (non-uniform faces; MixedSolver)")
    # turbulent inlets, equation 1 (the BC flags are checked per block)
    missing += not_ported(p, ())
    if p.dt_type != 0:
        missing.append(f"dt_type {p.dt_type} (compute_dt)")
    return missing


def build_ops(p: RunInput, ctype: int):
    """The FR operators of one element type from the deck's per-type
    options (solver.py:59-88 of the JAX package)."""
    if ctype == QUAD:
        return build_tensor_ops(QUAD, p.order, p.upts_type_quad,
                                p.vcjh_scheme_quad, p.eta_quad)
    if ctype == HEX:
        return build_tensor_ops(HEX, p.order, p.upts_type_hexa,
                                p.vcjh_scheme_hexa, p.eta_hexa)
    if ctype == TRI:
        return build_tri_ops(p.order, p.upts_type_tri, p.fpts_type_tri,
                             p.vcjh_scheme_tri, p.c_tri)
    if ctype == TET:
        return build_tet_ops(p.order, p.upts_type_tet, p.fpts_type_tet,
                             p.vcjh_scheme_tet, p.c_tet)
    raise NotImplementedError(f"hifiles_tpu_torch Solver: not ported yet: "
                              f"{CTYPE_NAMES.get(ctype, ctype)} blocks")


class Solver:
    """Single-element-type (quad, tri, hex or tet), single-device solver
    on ``device`` ("cuda", the default, or "cpu"), taking the port's own
    RunInput and MeshData (convert.run_input_from and convert.mesh_from
    turn the JAX package's into these)."""

    def __init__(self, run_input: RunInput, mesh: MeshData, device="cuda",
                 dtype=torch.float64):
        if not isinstance(run_input, RunInput):
            raise TypeError("Solver takes hifiles_tpu_torch's RunInput "
                            "(convert.run_input_from), got "
                            f"{type(run_input).__module__}")
        if not isinstance(mesh, MeshData):
            raise TypeError("Solver takes hifiles_tpu_torch's MeshData "
                            "(convert.mesh_from), got "
                            f"{type(mesh).__module__}")
        missing = _unsupported(run_input, mesh)
        if missing:
            raise NotImplementedError("hifiles_tpu_torch Solver: not ported "
                                      "yet: " + ", ".join(missing))
        self.p = run_input
        self.mesh = mesh
        self.device = select_device(device)
        self.dtype = dtype
        self.n_dims = mesh.n_dims
        self.n_fields = run_input.n_fields_for(self.n_dims)

        # boundary flags: group id -> BCFLAG (solver.py:43-53)
        if (mesh.bc_names and not run_input.bc_list
                and run_input._deck is not None):
            run_input.read_boundary_params(mesh.bc_names)
        if run_input.bc_list:
            bc_flags = {i: bc.flag for i, bc in enumerate(run_input.bc_list)}
        else:
            # built-in periodic meshes declare a single Cyclic group
            bc_flags = {0: CYCLIC}
        delta_cyclic = np.array([run_input.dx_cyclic, run_input.dy_cyclic,
                                 run_input.dz_cyclic])[:self.n_dims]
        self._bc_flags = bc_flags
        self.conn = build_faces(mesh, bc_flags, delta_cyclic)
        self.ops = build_ops(run_input, int(mesh.ctype[0]))
        self.block = build_element_block(
            mesh, self.conn, self.ops, delta_cyclic=delta_cyclic,
            over_int_order=(run_input.over_int_order if run_input.over_int
                            else None))

        nan0 = lambda x, v: v if np.isnan(x) else x
        self.rcfg = ResidualConfig(
            equation=run_input.equation, viscous=bool(run_input.viscous),
            riemann_solve_type=run_input.riemann_solve_type,
            gamma=run_input.gamma, prandtl=run_input.prandtl,
            mu_inf=nan0(run_input.mu_inf, 0.0),
            rt_inf=nan0(run_input.rt_inf, 1.0),
            c_sth=nan0(run_input.c_sth, 0.0),
            fix_vis=run_input.fix_vis, ldg_tau=run_input.ldg_tau,
            ldg_beta=run_input.ldg_beta, n_fields=self.n_fields,
            prandtl_t=run_input.prandtl_t, rans=bool(run_input.RANS),
            over_int=bool(run_input.over_int), les=bool(run_input.LES),
            sgs_model=run_input.SGS_model, C_s=run_input.C_s,
            filter_ratio=run_input.filter_ratio,
            filter_type=run_input.filter_type, kappa=run_input.Kappa,
            c_v1=run_input.c_v1, c_v2=run_input.c_v2, c_v3=run_input.c_v3,
            c_b1=run_input.c_b1, c_b2=run_input.c_b2, c_w2=run_input.c_w2,
            c_w3=run_input.c_w3, omega=run_input.omega)

        # wall distance for SA / wall-damped Smagorinsky / wall models
        # (solver.py:116-129; ref:src/geometry.cpp:708-894); 1e10
        # everywhere without walls
        if (run_input.RANS or run_input.wall_model
                or (run_input.LES and run_input.SGS_model == 0)):
            wall_slots = [
                self.block.bdy_slot[f][self.block.bdy_mask[f] > 0]
                for f, bcid in enumerate(self.block.bdy_bcid)
                if bc_flags.get(int(bcid), -1) in (ISOTHERM_WALL,
                                                   ADIABAT_WALL)]
            wall_pts = (self.block.pos_fpts[np.concatenate(wall_slots)]
                        if wall_slots else np.empty((0, self.n_dims)))
            self.block.compute_wall_distance(wall_pts)

        self._bc_fns = None
        if self.block.bdy_slot.size:
            self._bc_fns = make_bc_functions(run_input, self.block,
                                             self.rcfg, self.device, dtype)
        self.residual_soa = make_residual_soa(self.block, self.rcfg,
                                              self.device, dtype,
                                              self._bc_fns)

        # SVV model: replace the solution with its filtered version once per
        # step (solver.py:180-192; ref:src/eles.cpp:2087-2089)
        self._pre_step = None
        if run_input.LES and run_input.SGS_model == 3:
            svv = torch.as_tensor(
                build_les_filter(self.ops, run_input.filter_type,
                                 run_input.filter_ratio),
                dtype=dtype, device=self.device)
            self._pre_step = lambda u: (svv @ u.reshape(u.shape[0], -1)
                                        ).view(u.shape)

        # shock capture after every RK stage (solver.py:197-213)
        post_stage = None
        if run_input.shock_cap:
            post_stage = make_shock_capture_soa(
                self.ops, run_input.s0, run_input.expf_fac,
                run_input.expf_order, run_input.expf_cutoff,
                run_input.shock_det_field, self.n_dims, self.device, dtype)
        self.n_stages = N_STAGES[run_input.adv_type]
        self._setup_featured(post_stage)

        # initial condition at solution points (ref:src/solver.cpp:321-340)
        u0 = initial_condition(run_input, self.block.pos_upts, self.n_fields)
        if run_input.patch:
            u0 = apply_patch(run_input, self.block.pos_upts, u0)
        self.set_state(u0, np.zeros_like(u0), 0.0)

    def _setup_featured(self, post_stage):
        """The step and the featured carry (solver.py:216-269): BC ramp
        counter, body-forcing slots and weights, time averages."""
        p, mesh, ops, block = self.p, self.mesh, self.ops, self.block
        d, nF, dev, dt_ = self.n_dims, self.n_fields, self.device, self.dtype
        self._has_ramp = any(getattr(b, "pressure_ramp", 0)
                             for b in p.bc_list)
        self._forcing = bool(p.forcing) and p.equation == 0
        self._avg = bool(p.average_fields)
        for f_ in p.average_fields:
            if f_ not in AVERAGE_FIELDS:
                raise ValueError(f"unknown average field '{f_}'")
        self._featured = self._has_ramp or self._forcing or self._avg
        if self._forcing:
            # inflow plane = cyclic faces with normal -x
            # (ref:src/eles.cpp:5313-5337, the reference's inlet hack)
            fpt_off = np.concatenate([[0], np.cumsum(ops.n_fpts_per_face)])
            sl_list = []
            for c in range(mesh.n_cells):
                for k in range(NUM_F_PER_C[int(mesh.ctype[c])]):
                    bid = int(mesh.bc_id[c, k])
                    if bid < 0 or self._bc_flags.get(bid, -1) != CYCLIC:
                        continue
                    nfp = int(ops.n_fpts_per_face[k])
                    sl = c * ops.n_fpts + fpt_off[k] + np.arange(nfp)
                    if block.norm_fpts[sl[0], 0] < -0.99:
                        sl_list.append(sl)
            if not sl_list:
                raise ValueError("body forcing: no -x cyclic inflow plane")
            fs = np.concatenate(sl_list)
            self._force_slots = fs
            self._force_wdA = (ops.fpt_weights[fs % ops.n_fpts]
                               * block.tdA_fpts[fs])
            # the opp_0 extrapolation to the plane folded into one (U, E)
            # weight plane: sum_s w_s u_f(s) = sum_{u,e} W[u, e] u[u, e]
            W = np.zeros((ops.n_upts, block.n_eles))
            np.add.at(W.T, fs // ops.n_fpts,
                      self._force_wdA[:, None] * ops.opp_0[fs % ops.n_fpts])
            self._force_W = torch.as_tensor(W, dtype=dt_, device=dev)
            e1 = torch.zeros((nF, 1), dtype=dt_, device=dev)
            e1[1] = 1.0
            eE = torch.zeros((nF, 1), dtype=dt_, device=dev)
            eE[d + 1] = 1.0
            self._force_e = (e1, eE)
        # the step: the ramp counter and the body force are device tensors
        # updated in place each step, read by the residual and the source
        ramp = lambda: self._k if self._has_ramp else None
        residual = (lambda u: self.residual_soa(u, None, ramp())) \
            if self._has_ramp else self.residual_soa
        self._step = make_step_fn(
            residual, p.adv_type,
            source_fn=(lambda u: self._bf) if self._forcing else None,
            post_stage=post_stage)

    # ------------------------------------------------------------------
    def set_state(self, u, reg, time: float, *, iter_k=1, mdot_old=None,
                  t_sim=0.0, u_avg=None) -> None:
        """Take an (E, U, F) state and RK register (e.g. the JAX solver's)
        and the simulation time; and the featured carry: the ramp counter
        ``iter_k``, the forcing's mass-flux memory ``mdot_old`` (default
        body_force_mdot0), the averaging time ``t_sim`` and the (E, U, K)
        running averages ``u_avg`` (default zero)."""
        self.u_soa, self.reg_soa = state_from_numpy(u, reg, self.device,
                                                    self.dtype)
        self.time = float(time)
        scalar = lambda v: torch.tensor(float(v), dtype=self.dtype,
                                        device=self.device)
        p = self.p
        if mdot_old is None:
            mdot_old = p.body_force_mdot0 if self._forcing else 0.0
        self._k, self._mdot_old, self._t_sim = (
            scalar(iter_k), scalar(mdot_old), scalar(t_sim))
        self._bf = None
        self.u_avg_soa = None
        if self._avg:
            if u_avg is None:
                u_avg = np.zeros((u.shape[0], u.shape[1],
                                  len(p.average_fields)))
            self.u_avg_soa = euf_to_ufe(u_avg, self.device, self.dtype)

    @property
    def u(self) -> np.ndarray:
        """The state as (E, U, F) numpy, for diagnostics."""
        return ufe_to_euf(self.u_soa)

    @property
    def u_avg(self):
        """The running time averages as (E, U, K) numpy, or None."""
        return None if self.u_avg_soa is None else ufe_to_euf(self.u_avg_soa)

    @property
    def mdot_old(self) -> float:
        """The mass flux the forcing remembers from the last step."""
        return float(self._mdot_old)

    def run(self, n_steps: int, dt=None):
        """Advance n_steps RK steps of size dt (default: the deck's fixed
        dt) and return the (U, F, E) state tensor."""
        dt = float(self.p.dt if dt is None else dt)
        for _ in range(n_steps):
            if self._pre_step is not None:
                self.u_soa = self._pre_step(self.u_soa)
            if self._forcing:
                self._bf = self._body_force(self.u_soa, dt)
            self.u_soa, self.reg_soa = self._step(self.u_soa, self.reg_soa,
                                                  dt)
            if self._featured:
                self._t_sim += dt
                self._k += 1.0
                if self._avg:
                    self._average(dt)
        self.time += dt * n_steps
        return self.u_soa

    def _body_force(self, u, dt):
        """Channel/hill bulk-momentum forcing (solver.py:427-445;
        ref:src/eles.cpp:5281-5484 evaluate_body_force): the (F, 1) source
        column from the mass flux through the -x inflow plane, and the
        mass-flux memory updated, on the device."""
        p = self.p
        rho_int, mflux = (self._force_W[:, None] * u[:, :2]).sum(dim=(0, 2))
        ubulk = torch.where(rho_int == 0, 0.0, mflux / rho_int)
        area = p.body_force_area
        if p.body_force_type == 1:
            bf1 = (p.body_force_mdot0 - mflux) / (area * dt)
        else:
            bf1 = (p.body_force_mdot0 - 2.0 * mflux + self._mdot_old) \
                / (area * dt)
        self._mdot_old.copy_(mflux)
        e1, eE = self._force_e
        return e1 * bf1 + eE * (bf1 * ubulk)

    def _average(self, dt):
        """Running average after the step (solver.py:451-471;
        ref:src/eles.cpp:5676-5698)."""
        u, d = self.u_soa, self.n_dims
        rho = u[:, 0]
        col = {"rho_average": lambda: rho,
               "u_average": lambda: u[:, 1] / rho,
               "v_average": lambda: u[:, 2] / rho,
               "w_average": lambda: u[:, 3] / rho,
               "e_average": lambda: u[:, d + 1] / rho}
        cur = torch.stack([col[f_]() for f_ in self.p.average_fields],
                          dim=1)                              # (U, K, E)
        t_rel = self._t_sim - self.p.spinup_time
        a = (t_rel - dt) / t_rel
        b = dt / t_rel
        self.u_avg_soa = torch.where(t_rel <= dt, cur,
                                     a * self.u_avg_soa + b * cur)

    def inflow_massflux(self):
        """(mass_flux, ubulk, next body force) through the -x cyclic
        inflow plane, on the host (solver.py:689-711; the rows of the
        reference's massflux.dat, ref:src/eles.cpp:5430-5453).  The
        body-force value is the one the next step applies from this
        state; None without forcing."""
        if not self._forcing:
            return None
        u = self.u.astype(np.float64)
        d2 = np.einsum("pu,euf->epf", self.ops.opp_0, u).reshape(
            -1, self.n_fields)
        uf = d2[self._force_slots]
        w = np.asarray(self._force_wdA, dtype=np.float64)
        mflux = float((w * uf[:, 1]).sum())
        rho_int = float((w * uf[:, 0]).sum())
        ubulk = 0.0 if rho_int == 0 else mflux / rho_int
        p = self.p
        if p.body_force_type == 1:
            bf1 = (p.body_force_mdot0 - mflux) / (p.body_force_area * p.dt)
        else:
            bf1 = (p.body_force_mdot0 - 2.0 * mflux + self.mdot_old) \
                / (p.body_force_area * p.dt)
        return mflux, ubulk, bf1

    # ------------------------------------------------------------------
    def compute_error(self, norm_type: int | None = None) -> np.ndarray:
        """Volume-cubature error vs the analytic test case
        (ref:src/eles.cpp:5076-5136, ref:src/output.cpp:2052-2164).

        Returns (2, n_fields): [solution error, gradient error]; final norms
        are sqrt() for L2 outside.  The gradient row of the viscous test
        cases needs the gradient function, not ported yet."""
        p = self.p
        if p.viscous and p.test_case in (2, 3, 5):
            raise NotImplementedError(
                "hifiles_tpu_torch compute_error: gradient error row "
                "(gradient_fn) not ported yet")
        norm_type = norm_type if norm_type is not None else p.error_norm_type
        ops = self.ops
        disu_cub = np.einsum("cu,euf->ecf", ops.opp_vol_cubpts,
                             self.u.astype(np.float64))
        sol_a, _ = analytic_solution(p, self.block.pos_vol_cubpts,
                                     self.time, self.n_fields)
        err = disu_cub - sol_a
        w = ops.w_vol_cubpts[None, :] * self.block.detjac_vol_cubpts
        out = np.zeros((2, self.n_fields))
        if norm_type == 1:
            out[0] = np.einsum("ec,ecf->f", w, np.abs(err))
        else:
            out[0] = np.einsum("ec,ecf->f", w, err * err)
        return out

    def _monitor_residual(self) -> np.ndarray:
        """Residual of the current state, (E, U, F) numpy."""
        return ufe_to_euf(self.residual_soa(self.u_soa))

    def residual_norm(self, norm_type: int = 2,
                      r: np.ndarray | None = None) -> np.ndarray:
        """Residual norm with the reference's normalization
        (ref:src/output.cpp:2166-2247): L1 = sum|r|/n_pts,
        L2 = sqrt(sum r^2)/n_pts, inf = max|r|.  Accumulates in f64 on
        the host like the reference's double accumulators."""
        if r is None:
            r = self._monitor_residual()
        r = np.asarray(r, dtype=np.float64)
        n_pts = r.shape[0] * r.shape[1]
        if norm_type == 1:
            return np.abs(r).sum(axis=(0, 1)) / n_pts
        if norm_type == 2:
            return np.sqrt((r * r).sum(axis=(0, 1))) / n_pts
        return np.abs(r).max(axis=(0, 1))
