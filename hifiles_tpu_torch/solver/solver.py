"""Solver orchestration: config + mesh -> time stepping on a torch device.

Port of hifiles_tpu/solver/solver.py, simple path: one hex block, periodic
(interior faces only), the features of the SoA residual port, the SVV
pre-step filter and shock capture, fixed dt.  Setup runs once on the host
in numpy; the time loop is a Python loop of RK steps on the elements-minor
(U, F, E) state, which is transposed once here and not per chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from hifiles_tpu import HEX
from hifiles_tpu.config.params import (ADIABAT_WALL, CYCLIC, ISOTHERM_WALL,
                                       RunInput)
from hifiles_tpu.mesh.core import MeshData, build_faces
from hifiles_tpu.ops.les_filter import build_les_filter
from hifiles_tpu.ops.operators import build_tensor_ops

from ..backend import select_device
from ..convert import state_from_numpy, ufe_to_euf
from ..ops.stabilization import make_shock_capture_soa
from .elements import build_element_block
from .ics import analytic_solution, apply_patch, initial_condition
from .residual import ResidualConfig
from .residual_soa import make_residual_soa
from .step import N_STAGES, make_step_fn


def _unsupported(p: RunInput, mesh: MeshData) -> list:
    """Solver features this port does not cover yet (the residual's own
    are reported by residual_soa.unsupported)."""
    missing = []
    if not np.all(mesh.ctype == HEX):
        missing.append("element types other than hex")
    for flag, name in ((p.wall_model, "wall models"),
                       (p.forcing, "body forcing"),
                       (p.average_fields, "time averages")):
        if flag:
            missing.append(name)
    if p.dt_type != 0:
        missing.append(f"dt_type {p.dt_type} (compute_dt)")
    return missing


class Solver:
    """Single-hex-block, single-device solver on ``device`` ("cpu" or
    "cuda"), taking the JAX package's RunInput and MeshData."""

    def __init__(self, run_input: RunInput, mesh: MeshData, device="cpu",
                 dtype=torch.float64):
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
        self.conn = build_faces(mesh, bc_flags, delta_cyclic)
        self.ops = build_tensor_ops(
            HEX, run_input.order, run_input.upts_type_hexa,
            run_input.vcjh_scheme_hexa, run_input.eta_hexa)
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

        # wall distance for SA / wall-damped Smagorinsky (solver.py:116-129;
        # ref:src/geometry.cpp:708-894); 1e10 everywhere without walls
        if run_input.RANS or (run_input.LES and run_input.SGS_model == 0):
            wall_slots = [
                self.block.bdy_slot[f][self.block.bdy_mask[f] > 0]
                for f, bcid in enumerate(self.block.bdy_bcid)
                if bc_flags.get(int(bcid), -1) in (ISOTHERM_WALL,
                                                   ADIABAT_WALL)]
            wall_pts = (self.block.pos_fpts[np.concatenate(wall_slots)]
                        if wall_slots else np.empty((0, self.n_dims)))
            self.block.compute_wall_distance(wall_pts)

        self.residual_soa = make_residual_soa(self.block, self.rcfg,
                                              self.device, dtype)

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
        self._step = make_step_fn(self.residual_soa, run_input.adv_type,
                                  post_stage=post_stage)
        self.n_stages = N_STAGES[run_input.adv_type]

        # initial condition at solution points (ref:src/solver.cpp:321-340)
        u0 = initial_condition(run_input, self.block.pos_upts, self.n_fields)
        if run_input.patch:
            u0 = apply_patch(run_input, self.block.pos_upts, u0)
        self.set_state(u0, np.zeros_like(u0), 0.0)

    # ------------------------------------------------------------------
    def set_state(self, u, reg, time: float) -> None:
        """Take an (E, U, F) state and RK register (e.g. the JAX solver's)
        and the simulation time."""
        self.u_soa, self.reg_soa = state_from_numpy(u, reg, self.device,
                                                    self.dtype)
        self.time = float(time)

    @property
    def u(self) -> np.ndarray:
        """The state as (E, U, F) numpy, for diagnostics."""
        return ufe_to_euf(self.u_soa)

    def run(self, n_steps: int, dt=None):
        """Advance n_steps RK steps of size dt (default: the deck's fixed
        dt) and return the (U, F, E) state tensor."""
        dt = float(self.p.dt if dt is None else dt)
        for _ in range(n_steps):
            if self._pre_step is not None:
                self.u_soa = self._pre_step(self.u_soa)
            self.u_soa, self.reg_soa = self._step(self.u_soa, self.reg_soa,
                                                  dt)
        self.time += dt * n_steps
        return self.u_soa

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
