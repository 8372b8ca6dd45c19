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

``BlockLoop`` holds what Solver shares with multiblock.MixedSolver, for
which a single-type mesh is a mixed mesh with one block: the state is one
tensor holding each block's (U_t, F, E_t) state as a contiguous view, and
the time loop, the featured carry and the diagnostics run block by block
on those views.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import CTYPE_NAMES, HEX, PRISM, QUAD, TET, TRI
from ..config.params import ADIABAT_WALL, CYCLIC, ISOTHERM_WALL, RunInput
from ..mesh.core import NUM_F_PER_C, MeshData, build_faces
from ..ops.les_filter import build_les_filter
from ..ops.operators import (build_pri_ops, build_tensor_ops, build_tet_ops,
                             build_tri_ops)

from ..backend import select_device
from ..convert import euf_to_ufe, ufe_to_euf
from ..ops.stabilization import make_shock_capture_soa
from .bc import make_bc_functions, not_ported
from .elements import build_element_block
from .ics import analytic_solution, apply_patch, initial_condition
from .residual import ResidualConfig
from .residual_soa import make_residual_soa
from .step import N_STAGES, make_step_fn


AVERAGE_FIELDS = ("rho_average", "u_average", "v_average", "w_average",
                  "e_average")


def not_ported_run(p: RunInput) -> list:
    """Run features this port does not cover yet on any mesh (the
    residual's own are reported by residual_soa.config_missing)."""
    # turbulent inlets, equation 1 (the BC flags are checked per block)
    missing = not_ported(p, ())
    if p.dt_type != 0:
        missing.append(f"dt_type {p.dt_type} (compute_dt)")
    return missing


def _unsupported(p: RunInput, mesh: MeshData) -> list:
    """Solver features this port does not cover yet."""
    missing = []
    types = np.unique(mesh.ctype)
    if types.size > 1:
        missing.append("mixed element types ("
                       + ", ".join(CTYPE_NAMES[int(t)] for t in types)
                       + "; use hifiles_tpu_torch.MixedSolver)")
    elif int(types[0]) == PRISM:
        missing.append("prism blocks (non-uniform faces; use "
                       "hifiles_tpu_torch.MixedSolver)")
    return missing + not_ported_run(p)


def build_ops(p: RunInput, ctype: int):
    """The FR operators of one element type from the deck's per-type
    options (solver.py:59-88 and multiblock.py:80-105 of the JAX
    package)."""
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
    if ctype == PRISM:
        return build_pri_ops(p.order, p.upts_type_pri_tri,
                             p.upts_type_pri_1d, p.vcjh_scheme_pri_1d,
                             p.eta_pri, p.vcjh_scheme_tri, p.c_tri)
    raise ValueError(f"unknown element type {ctype}")


def residual_config(p: RunInput, n_fields: int) -> ResidualConfig:
    """The residual's parameters from the deck (solver.py:93-114 of the
    JAX package)."""
    nan0 = lambda x, v: v if np.isnan(x) else x
    return ResidualConfig(
        equation=p.equation, viscous=bool(p.viscous),
        riemann_solve_type=p.riemann_solve_type,
        gamma=p.gamma, prandtl=p.prandtl,
        mu_inf=nan0(p.mu_inf, 0.0), rt_inf=nan0(p.rt_inf, 1.0),
        c_sth=nan0(p.c_sth, 0.0),
        fix_vis=p.fix_vis, ldg_tau=p.ldg_tau, ldg_beta=p.ldg_beta,
        n_fields=n_fields, prandtl_t=p.prandtl_t, rans=bool(p.RANS),
        over_int=bool(p.over_int), les=bool(p.LES),
        sgs_model=p.SGS_model, C_s=p.C_s, filter_ratio=p.filter_ratio,
        filter_type=p.filter_type, kappa=p.Kappa,
        c_v1=p.c_v1, c_v2=p.c_v2, c_v3=p.c_v3, c_b1=p.c_b1, c_b2=p.c_b2,
        c_w2=p.c_w2, c_w3=p.c_w3, omega=p.omega)


def needs_wall_distance(p: RunInput) -> bool:
    """SA, wall models and wall-damped Smagorinsky read the wall distance
    (solver.py:116-129; ref:src/geometry.cpp:708-894)."""
    return bool(p.RANS or p.wall_model or (p.LES and p.SGS_model == 0))


def wall_points(bdy_slot, bdy_mask, bdy_bcid, pos_fpts, bc_flags, d):
    """The flux points of the no-slip wall faces (d columns), whose
    nearest distance is the wall distance; 1e10 everywhere without
    walls."""
    slots = [bdy_slot[f][bdy_mask[f] > 0]
             for f, bcid in enumerate(bdy_bcid)
             if bc_flags.get(int(bcid), -1) in (ISOTHERM_WALL, ADIABAT_WALL)]
    return pos_fpts[np.concatenate(slots)] if slots else np.empty((0, d))


def _per_block(x):
    """A tuple of per-block arrays: ``x`` itself if a tuple or list, else
    the one array of a single block."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class BlockLoop:
    """The time loop, featured carry and diagnostics of a solver whose
    state is one or several element blocks (Solver, MixedSolver).

    A subclass sets up the deck and mesh with ``_setup``, builds its
    blocks and residual, and calls ``_setup_loop`` with its blocks in state
    order, each block's global cell ids, and ``rhs(u, ramp)``, which maps a
    state tensor to a new right-hand-side tensor of the same layout."""

    def _setup(self, run_input: RunInput, mesh: MeshData, device, dtype,
               unsupported):
        name = type(self).__name__
        if not isinstance(run_input, RunInput):
            raise TypeError(f"{name} takes hifiles_tpu_torch's RunInput "
                            "(convert.run_input_from), got "
                            f"{type(run_input).__module__}")
        if not isinstance(mesh, MeshData):
            raise TypeError(f"{name} takes hifiles_tpu_torch's MeshData "
                            "(convert.mesh_from), got "
                            f"{type(mesh).__module__}")
        missing = unsupported(run_input, mesh)
        if missing:
            raise NotImplementedError(f"hifiles_tpu_torch {name}: not ported "
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
        self.delta_cyclic = np.array([run_input.dx_cyclic,
                                      run_input.dy_cyclic,
                                      run_input.dz_cyclic])[:self.n_dims]
        self._bc_flags = bc_flags
        self.conn = build_faces(mesh, bc_flags, self.delta_cyclic)
        self.rcfg = residual_config(run_input, self.n_fields)

    def _setup_loop(self, blocks, sels, rhs):
        p, dt_, dev = self.p, self.dtype, self.device
        self._blocks, self._sels, self._rhs = blocks, sels, rhs
        self._shapes = [(b.ops.n_upts, b.n_eles) for b in blocks]
        self.dof = sum(U * E for U, E in self._shapes)
        # SVV model: replace the solution with its filtered version once
        # per step (solver.py:180-192; ref:src/eles.cpp:2087-2089)
        self._pre_step = None
        if p.LES and p.SGS_model == 3:
            svv = [torch.as_tensor(build_les_filter(b.ops, p.filter_type,
                                                    p.filter_ratio),
                                   dtype=dt_, device=dev) for b in blocks]

            def pre_step(u):
                out = self._alloc()
                for s, v, o in zip(svv, self._views(u), self._views(out)):
                    torch.matmul(s, v.reshape(v.shape[0], -1),
                                 out=o.view(o.shape[0], -1))
                return out
            self._pre_step = pre_step
        # shock capture after every RK stage, in place on each block
        # (solver.py:197-213, multiblock.py:501-525)
        post_stage = None
        if p.shock_cap:
            caps = [make_shock_capture_soa(
                b.ops, p.s0, p.expf_fac, p.expf_order, p.expf_cutoff,
                p.shock_det_field, self.n_dims, dev, dt_) for b in blocks]

            def post_stage(u):
                for cap, v in zip(caps, self._views(u)):
                    cap(v)
                return u
        self.n_stages = N_STAGES[p.adv_type]
        self._setup_featured()

        def stage_rhs(u):
            r = rhs(u, self._k if self._has_ramp else None)
            if self._forcing:
                # the body force, an (F, 1) column (ref:src/eles.cpp:
                # 1095-1247 adds the source to every stage's rhs)
                for v in self._views(r):
                    v.add_(self._bf)
            return r
        self._step = make_step_fn(stage_rhs, p.adv_type,
                                  post_stage=post_stage)

    def _setup_featured(self):
        """The featured carry (solver.py:216-269, multiblock.py:552-722):
        BC ramp counter, body-forcing slots and weights per block, time
        averages."""
        p, mesh, blocks = self.p, self.mesh, self._blocks
        d, nF, dev, dt_ = self.n_dims, self.n_fields, self.device, self.dtype
        self._has_ramp = any(getattr(b, "pressure_ramp", 0)
                             for b in p.bc_list)
        self._forcing = bool(p.forcing) and p.equation == 0
        self._avg = bool(p.average_fields)
        for f_ in p.average_fields:
            if f_ not in AVERAGE_FIELDS:
                raise ValueError(f"unknown average field '{f_}'")
        self._featured = self._has_ramp or self._forcing or self._avg
        if not self._forcing:
            return
        # inflow plane = cyclic faces with normal -x, per block
        # (ref:src/eles.cpp:5313-5337, the reference's inlet hack)
        where = np.zeros((mesh.n_cells, 2), dtype=np.int64)
        for i, sel in enumerate(self._sels):
            where[sel, 0] = i
            where[sel, 1] = np.arange(sel.size)
        fpt_off = [np.concatenate([[0], np.cumsum(b.ops.n_fpts_per_face)])
                   for b in blocks]
        slots = [[] for _ in blocks]
        for c in range(mesh.n_cells):
            i, loc = where[c]
            ops = blocks[i].ops
            for k in range(NUM_F_PER_C[int(mesh.ctype[c])]):
                bid = int(mesh.bc_id[c, k])
                if bid < 0 or self._bc_flags.get(bid, -1) != CYCLIC:
                    continue
                nfp = int(ops.n_fpts_per_face[k])
                sl = loc * ops.n_fpts + fpt_off[i][k] + np.arange(nfp)
                if blocks[i].norm_fpts[sl[0], 0] < -0.99:
                    slots[i].append(sl)
        if not any(slots):
            raise ValueError("body forcing: no -x cyclic inflow plane")
        # per block with inflow faces: (block, slots, weights w * tdA, the
        # opp_0 extrapolation to the plane folded into one (U, E) weight
        # plane: sum_s w_s u_f(s) = sum_{u,e} W[u, e] u[u, e])
        self._force = []
        for i, sl in enumerate(slots):
            if not sl:
                continue
            b, fs = blocks[i], np.concatenate(sl)
            Pf = b.ops.n_fpts
            wdA = b.ops.fpt_weights[fs % Pf] * b.tdA_fpts[fs]
            W = np.zeros((b.ops.n_upts, b.n_eles))
            np.add.at(W.T, fs // Pf, wdA[:, None] * b.ops.opp_0[fs % Pf])
            self._force.append((i, fs, wdA,
                                torch.as_tensor(W, dtype=dt_, device=dev)))
        e1 = torch.zeros((nF, 1), dtype=dt_, device=dev)
        e1[1] = 1.0
        eE = torch.zeros((nF, 1), dtype=dt_, device=dev)
        eE[d + 1] = 1.0
        self._force_e = (e1, eE)

    # ------------------------------------------------------------------
    def _views(self, x, K=None):
        """Each block's (U_t, K, E_t) view of the state-layout tensor x
        (K = n_fields by default)."""
        K = self.n_fields if K is None else K
        flat, out, o = x.view(-1), [], 0
        for U, E in self._shapes:
            out.append(flat[o:o + U * K * E].view(U, K, E))
            o += U * K * E
        return tuple(out)

    def _alloc(self, K=None):
        """An empty state-layout tensor with K fields: the (U, K, E) tensor
        of a single block, or the blocks' states end to end."""
        K = self.n_fields if K is None else K
        if len(self._shapes) == 1:
            U, E = self._shapes[0]
            return torch.empty((U, K, E), dtype=self.dtype,
                               device=self.device)
        return torch.empty(sum(U * K * E for U, E in self._shapes),
                           dtype=self.dtype, device=self.device)

    def _from_numpy(self, arrays, K=None):
        """(E_t, U_t, K) arrays, one per block -> a state-layout tensor."""
        x = self._alloc(K)
        for v, a in zip(self._views(x, K), arrays):
            v.copy_(euf_to_ufe(a, self.device, self.dtype))
        return x

    def _to_numpy(self, x, K=None):
        """A state-layout tensor -> (E_t, U_t, K) numpy arrays per block."""
        return tuple(ufe_to_euf(v) for v in self._views(x, K))

    def set_state(self, u, reg, time: float, *, iter_k=1, mdot_old=None,
                  t_sim=0.0, u_avg=None) -> None:
        """Take an (E, U, F) state and RK register per block (a tuple in
        block order; a single block's arrays may come bare), e.g. the JAX
        solver's, and the simulation time; and the featured carry: the
        ramp counter ``iter_k``, the forcing's mass-flux memory
        ``mdot_old`` (default body_force_mdot0), the averaging time
        ``t_sim`` and the (E, U, K) running averages ``u_avg`` (default
        zero)."""
        self.u_soa = self._from_numpy(_per_block(u))
        self.reg_soa = self._from_numpy(_per_block(reg))
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
            K = len(p.average_fields)
            if u_avg is None:
                u_avg = [np.zeros((E, U, K)) for U, E in self._shapes]
            self.u_avg_soa = self._from_numpy(_per_block(u_avg), K)

    def _state_out(self, arrays):
        """What the ``u`` and ``u_avg`` properties return for the per-block
        arrays: the tuple itself."""
        return arrays

    @property
    def u(self):
        """The state as (E, U, F) numpy per block, for diagnostics."""
        return self._state_out(self._to_numpy(self.u_soa))

    @property
    def u_avg(self):
        """The running time averages as (E, U, K) numpy per block, or
        None."""
        if self.u_avg_soa is None:
            return None
        return self._state_out(self._to_numpy(self.u_avg_soa,
                                              len(self.p.average_fields)))

    @property
    def mdot_old(self) -> float:
        """The mass flux the forcing remembers from the last step."""
        return float(self._mdot_old)

    def compute_dt(self) -> float:
        """The time step (solver.py and multiblock.py compute_dt of the JAX
        package): the deck's fixed dt; the solvers refuse dt_type != 0 when
        they are built."""
        return float(self.p.dt)

    def run(self, n_steps: int, dt=None):
        """Advance n_steps RK steps of size dt (default: compute_dt()) and
        return the state tensor."""
        dt = self.compute_dt() if dt is None else float(dt)
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
        views = self._views(u)
        acc = None
        for i, _, _, W in self._force:
            part = (W[:, None] * views[i][:, :2]).sum(dim=(0, 2))
            acc = part if acc is None else acc + part
        rho_int, mflux = acc
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
        ref:src/eles.cpp:5676-5698), block by block."""
        d, fields = self.n_dims, self.p.average_fields
        t_rel = self._t_sim - self.p.spinup_time
        a = (t_rel - dt) / t_rel
        b = dt / t_rel
        for u, avg in zip(self._views(self.u_soa),
                          self._views(self.u_avg_soa, len(fields))):
            rho = u[:, 0]
            col = {"rho_average": lambda: rho,
                   "u_average": lambda: u[:, 1] / rho,
                   "v_average": lambda: u[:, 2] / rho,
                   "w_average": lambda: u[:, 3] / rho,
                   "e_average": lambda: u[:, d + 1] / rho}
            cur = torch.stack([col[f_]() for f_ in fields], dim=1)
            avg.copy_(torch.where(t_rel <= dt, cur, a * avg + b * cur))

    def inflow_massflux(self):
        """(mass_flux, ubulk, next body force) through the -x cyclic
        inflow plane, summed over the blocks on the host (solver.py:
        689-711, multiblock.py:876-901; the rows of the reference's
        massflux.dat, ref:src/eles.cpp:5430-5453).  The body-force value
        is the one the next step applies from this state; None without
        forcing."""
        if not self._forcing:
            return None
        us = self._to_numpy(self.u_soa)
        mflux = rho_int = 0.0
        for i, fs, wdA, _ in self._force:
            d2 = np.einsum("pu,euf->epf", self._blocks[i].ops.opp_0,
                           us[i].astype(np.float64)).reshape(
                               -1, self.n_fields)
            uf = d2[fs]
            w = np.asarray(wdA, dtype=np.float64)
            mflux += float((w * uf[:, 1]).sum())
            rho_int += float((w * uf[:, 0]).sum())
        ubulk = 0.0 if rho_int == 0 else mflux / rho_int
        p = self.p
        if p.body_force_type == 1:
            bf1 = (p.body_force_mdot0 - mflux) / (p.body_force_area * p.dt)
        else:
            bf1 = (p.body_force_mdot0 - 2.0 * mflux + self.mdot_old) \
                / (p.body_force_area * p.dt)
        return mflux, ubulk, bf1

    # ------------------------------------------------------------------
    def _cubature(self):
        """Per block: the state at the volume cubature points (E, C, F)
        and the weights w * det (E, C)."""
        for b, u in zip(self._blocks, self._to_numpy(self.u_soa)):
            yield (b, np.einsum("cu,euf->ecf", b.ops.opp_vol_cubpts,
                                u.astype(np.float64)),
                   b.ops.w_vol_cubpts[None, :] * b.detjac_vol_cubpts)

    def compute_error(self, norm_type: int | None = None) -> np.ndarray:
        """Volume-cubature error vs the analytic test case, summed over the
        blocks (ref:src/eles.cpp:5076-5136, ref:src/output.cpp:2052-2164).

        Returns (2, n_fields): [solution error, gradient error]; final norms
        are sqrt() for L2 outside.  The gradient row of the viscous test
        cases needs the gradient function, not ported yet."""
        p = self.p
        if p.viscous and p.test_case in (2, 3, 5):
            raise NotImplementedError(
                "hifiles_tpu_torch compute_error: gradient error row "
                "(gradient_fn) not ported yet")
        norm_type = norm_type if norm_type is not None else p.error_norm_type
        out = np.zeros((2, self.n_fields))
        for b, disu_cub, w in self._cubature():
            sol_a, _ = analytic_solution(p, b.pos_vol_cubpts, self.time,
                                         self.n_fields)
            err = disu_cub - sol_a
            if norm_type == 1:
                out[0] += np.einsum("ec,ecf->f", w, np.abs(err))
            else:
                out[0] += np.einsum("ec,ecf->f", w, err * err)
        return out

    def total_mass_energy(self) -> np.ndarray:
        """Volume integrals of the conserved fields, summed over the blocks
        (multiblock.py:951-960; a conservation check)."""
        tot = np.zeros(self.n_fields)
        for _, disu_cub, w in self._cubature():
            tot += np.einsum("ec,ecf->f", w, disu_cub)
        return tot

    def _monitor_residual(self):
        """Residual of the current state, (E, U, F) numpy per block."""
        return self._state_out(self._to_numpy(self._rhs(self.u_soa, None)))

    def residual_norm(self, norm_type: int = 2, r=None) -> np.ndarray:
        """Residual norm over every block's solution points with the
        reference's normalization (ref:src/output.cpp:2166-2247): L1 =
        sum|r|/n_pts, L2 = sqrt(sum r^2)/n_pts, inf = max|r|.  ``r``: the
        (E, U, F) residual per block (default: the current state's).
        Accumulates in f64 on the host like the reference's double
        accumulators."""
        if r is None:
            r = self._monitor_residual()
        rs = [np.asarray(x, dtype=np.float64) for x in _per_block(r)]
        n_pts = sum(x.shape[0] * x.shape[1] for x in rs)
        if norm_type == 1:
            return sum(np.abs(x).sum(axis=(0, 1)) for x in rs) / n_pts
        if norm_type == 2:
            return np.sqrt(sum((x * x).sum(axis=(0, 1)) for x in rs)) / n_pts
        return np.max([np.abs(x).max(axis=(0, 1)) for x in rs], axis=0)


class Solver(BlockLoop):
    """Single-element-type (quad, tri, hex or tet), single-device solver
    on ``device`` ("cuda", the default, or "cpu"), taking the port's own
    RunInput and MeshData (convert.run_input_from and convert.mesh_from
    turn the JAX package's into these).  Prisms and mixed meshes run
    through MixedSolver."""

    def __init__(self, run_input: RunInput, mesh: MeshData, device="cuda",
                 dtype=torch.float64):
        self._setup(run_input, mesh, device, dtype, _unsupported)
        self.ops = build_ops(run_input, int(mesh.ctype[0]))
        self.block = build_element_block(
            mesh, self.conn, self.ops, delta_cyclic=self.delta_cyclic,
            over_int_order=(run_input.over_int_order if run_input.over_int
                            else None))
        if needs_wall_distance(run_input):
            b = self.block
            b.compute_wall_distance(wall_points(
                b.bdy_slot, b.bdy_mask, b.bdy_bcid, b.pos_fpts,
                self._bc_flags, self.n_dims))

        self._bc_fns = None
        if self.block.bdy_slot.size:
            self._bc_fns = make_bc_functions(run_input, self.block,
                                             self.rcfg, self.device, dtype)
        self.residual_soa = make_residual_soa(self.block, self.rcfg,
                                              self.device, dtype,
                                              self._bc_fns)
        self._setup_loop([self.block], [np.arange(mesh.n_cells)],
                         lambda u, ramp: self.residual_soa(u, None, ramp))

        # initial condition at solution points (ref:src/solver.cpp:321-340)
        u0 = initial_condition(run_input, self.block.pos_upts, self.n_fields)
        if run_input.patch:
            u0 = apply_patch(run_input, self.block.pos_upts, u0)
        self.set_state(u0, np.zeros_like(u0), 0.0)

    @staticmethod
    def _state_out(arrays):
        """The one block's array."""
        return arrays[0]
