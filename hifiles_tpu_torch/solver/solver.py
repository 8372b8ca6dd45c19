"""Solver orchestration: config + mesh -> time stepping on a torch device.

Port of hifiles_tpu/solver/solver.py (:32-276) for one quad, tri, hex or
tet block: the "SoA (fast)" chunk and the "SoA featured (fast)" chunk
(solver.py:380-482), i.e. the
features of the SoA residual port with boundary conditions and wall models,
the SVV pre-step filter, shock capture, the BC ramp counter, the turbulent
inlet (white noise or SEM, updated once per step), bulk-momentum body
forcing and running time averages; fixed, global CFL or per-element
local time steps (compute_dt, solver.py:570-641); and the diagnostics the
writers read (the corrected gradient, the shock sensor, the analytic error
with its gradient row).  Setup runs once on the
host in numpy; the time loop steps the elements-minor (U, F, E) state.
The featured carry (ramp counter, mass-flux memory, simulated time,
averages, the inlet's eddies) stays in device tensors of the state's
dtype, as the JAX scan carry does, so a step never waits for the device.

The JAX package compiles a chunk of steps into one program (``jax.jit`` of
``_make_run_chunk``, solver.py:273-482, a ``lax.scan`` over the steps).
The port's counterpart (``BlockLoop._make_run_chunk``) captures one whole
step once as a CUDA graph (solver/graph.py) and replays it: every buffer
the step reads or writes (the state, the RK register, the featured carry,
the inlet's eddies and fluctuations, the body-force column and dt itself)
is allocated once and never rebound, and everything outside the step
(set_state, restore, the dt of each ``run``) copies into it.

``BlockLoop`` holds what Solver shares with multiblock.MixedSolver, for
which a single-type mesh is a mixed mesh with one block: the state is one
tensor holding each block's (U_t, F, E_t) state as a contiguous view, and
the time loop, the featured carry and the diagnostics run block by block
on those views.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import CTYPE_NAMES, HEX, PRISM, QUAD, TET, TRI, tracing
from ..config.params import ADIABAT_WALL, CYCLIC, ISOTHERM_WALL, RunInput
from ..io.history import CHUNK
from ..mesh.core import NUM_F_PER_C, MeshData, build_faces
from ..ops.les_filter import build_les_filter
from ..ops.operators import (build_pri_ops, build_tensor_ops, build_tet_ops,
                             build_tri_ops)

from ..backend import select_device
from ..convert import euf_to_ufe, ufe_to_euf
from ..models.euler import max_wavespeed
from ..models.viscous import sutherland_mu
from ..ops.stabilization import make_shock_capture_soa
from .bc import BCFunctions, make_bc_functions
from .elements import build_element_block
from .graph import CudaStepGraph
from .ics import analytic_solution, apply_patch, initial_condition
from .residual import ResidualConfig
from .residual_soa import make_residual_soa
from .step import N_STAGES, make_step_fn
from .turb_inlet import build_turb_inlet


AVERAGE_FIELDS = ("rho_average", "u_average", "v_average", "w_average",
                  "e_average")


def _unsupported(p: RunInput, mesh: MeshData) -> list:
    """What Solver does not run: meshes for MixedSolver."""
    missing = []
    types = np.unique(mesh.ctype)
    if types.size > 1:
        missing.append("mixed element types ("
                       + ", ".join(CTYPE_NAMES[int(t)] for t in types)
                       + "; use hifiles_tpu_torch.MixedSolver)")
    elif int(types[0]) == PRISM:
        missing.append("prism blocks (non-uniform faces; use "
                       "hifiles_tpu_torch.MixedSolver)")
    return missing


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
        wave_speed=tuple(p.wave_speed), lambda_lf=p.lambda_lf,
        diff_coeff=p.diff_coeff,
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


def cfl_dt(p: RunInput, u, h_ref, d: int):
    """The per-element CFL time step (E,) of a (U, F, E) state with the
    elements' reference lengths ``h_ref`` (E,) (solver.py:570-613 of the
    JAX package; ref:src/eles.cpp:1267-1356): the inviscid limit from the
    largest |v| + c and, viscous, the limit from max(4/3, gamma/Pr)
    mu/rho, on the state's device in its dtype."""
    CFL = p.CFL
    u = u.unbind(1)
    lam = max_wavespeed(u, p.gamma, d).amax(dim=0)
    dt_ele = CFL * h_ref / lam / (2 * p.order + 1)
    if p.viscous and p.equation == 0:
        rho = u[0]
        ke = 0.5 * sum(u[1 + m] ** 2 for m in range(d)) / rho
        inte = (u[d + 1] - ke) / rho
        mu = sutherland_mu(inte, p.gamma, p.mu_inf, p.rt_inf, p.c_sth,
                           p.fix_vis)
        lam_v = (max(4.0 / 3.0, p.gamma / p.prandtl)
                 * mu / rho).amax(dim=0)
        dt_ele = torch.minimum(
            dt_ele, CFL * 0.25 * h_ref ** 2 / lam_v / (2 * p.order + 1))
    return dt_ele


def _per_block(x):
    """A tuple of per-block arrays: ``x`` itself if a tuple or list, else
    the one array of a single block."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _log_run_path(solver_name: str, path: str) -> None:
    """One line naming the run path a solver took, on stderr, as the JAX
    package's log_residual_path (hifiles_tpu/utils/__init__.py:9-17);
    silenced with HIFILES_QUIET=1."""
    if not os.environ.get("HIFILES_QUIET"):
        print(f"hifiles_tpu_torch: {solver_name} run path = {path}",
              file=sys.stderr)


class BlockLoop:
    """The time loop, featured carry and diagnostics of a solver whose
    state is one or several element blocks (Solver, MixedSolver).

    A subclass sets up the deck and mesh with ``_setup``, builds its
    blocks and residual, the turbulent inlet with ``_setup_inlet``, and
    calls ``_setup_loop`` with its blocks in state order, each block's
    global cell ids, and ``rhs(u, ramp, fluc=None)``, which maps a state
    tensor to a new right-hand-side tensor of the same layout.

    ``run`` steps through ``_make_run_chunk``: on the card one step is
    captured as a CUDA graph and replayed; ``_step_graph`` makes the
    graph (graph.CudaStepGraph; a test may set a stand-in that captures
    on the CPU)."""

    _step_graph = None

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
        with tracing.span("setup.faces"):
            self.conn = build_faces(mesh, bc_flags, self.delta_cyclic)
        self.rcfg = residual_config(run_input, self.n_fields)

    def _setup_inlet(self, block, plane_index, plane_shape, fpt_rows,
                     slots=None):
        """The turbulent inlet, when LES runs and a boundary group has
        inlet_type > 0 (solver.py:168-178, multiblock.py:464-471 of the
        JAX package): ``block`` the element block or multiblock._TIFacade,
        ``plane_index`` and ``plane_shape`` the boundary planes of the
        face stage (turb_inlet.build_turb_inlet), ``fpt_rows(u)`` the
        flux-point rows (F, S) of a state, and ``slots`` their columns
        that hold the inlet points (default: the block's slots).  The
        inlet draws from a device generator seeded with 0 until
        ``set_inlet_draws``."""
        self.turb_inlet = self._ti_state = self._fluc = None
        if not (self.p.LES and self._bc_fns is not None):
            return
        self.turb_inlet = build_turb_inlet(
            self.p, block, lambda bcid: BCFunctions(
                self.p, bcid, self.n_dims, self.rcfg, self.device,
                self.dtype), plane_index, plane_shape, self.device,
            self.dtype, slots=slots)
        if self.turb_inlet is not None:
            pos, sgn, draws = self.turb_inlet.init_state
            self._ti_state = (pos.clone(), sgn.clone(), draws)
            self._fpt_rows = fpt_rows
            self._fluc = torch.zeros((self.n_dims,) + tuple(plane_shape),
                                     dtype=self.dtype, device=self.device)

    def set_inlet_draws(self, draws):
        """Take the turbulent inlet's random draws from ``draws`` (a
        turb_inlet.DeviceDraws or ReplayDraws) from the next step on (a
        captured step is captured anew)."""
        pos, sgn, _ = self._ti_state
        self._ti_state = (pos, sgn, draws)

    def _setup_loop(self, blocks, sels, rhs, devices=None):
        """``devices``: each block's device (default: the solver's)."""
        p, dt_ = self.p, self.dtype
        self._blocks, self._sels, self._rhs = blocks, sels, rhs
        self._devs = devices or [self.device] * len(blocks)
        self._shapes = [(b.ops.n_upts, b.n_eles) for b in blocks]
        self.dof = sum(U * E for U, E in self._shapes)
        # SVV model: replace the solution with its filtered version once
        # per step (solver.py:180-192; ref:src/eles.cpp:2087-2089)
        self._pre_step = None
        if p.LES and p.SGS_model == 3:
            svv = [torch.as_tensor(build_les_filter(b.ops, p.filter_type,
                                                    p.filter_ratio),
                                   dtype=dt_, device=dev)
                   for b, dev in zip(blocks, self._devs)]

            def pre_step(u):
                """The filtered state, written back into ``u``."""
                out = self._alloc()
                for s, v, o in zip(svv, self._views(u), self._views(out)):
                    torch.matmul(s, v.reshape(v.shape[0], -1),
                                 out=o.view(o.shape[0], -1))
                u.copy_(out)
            self._pre_step = pre_step
        # shock capture after every RK stage, in place on each block
        # (solver.py:197-213, multiblock.py:501-525); its sensors are the
        # sensor_fn diagnostics
        post_stage = None
        self._caps = None
        if p.shock_cap:
            self._caps = caps = [make_shock_capture_soa(
                b.ops, p.s0, p.expf_fac, p.expf_order, p.expf_cutoff,
                p.shock_det_field, self.n_dims, dev, dt_)
                for b, dev in zip(blocks, self._devs)]

            def post_stage(u):
                for cap, v in zip(caps, self._views(u)):
                    cap(v)
                return u
        self.n_stages = N_STAGES[p.adv_type]
        self._setup_featured()
        # the run chunk's state: its step graph, what it was captured for
        # (dt's kind, the inlet's draw object) and the dt buffers; the
        # captures and replays made so far
        self._graph = self._graph_key = None
        self._graph_launches = self._capture_span = None
        self.captures = self.replays = 0
        self.run_path, self._logged = None, set()
        self._dt_kind = "global"
        self._dt_s = torch.zeros((), dtype=dt_, device=self.device)
        self._dt_rk = self._global_dt_rk()
        # the state and featured carry, bound by the first set_state
        self.u_soa = self.reg_soa = self.u_avg_soa = None
        self._k = self._mdot_old = self._t_sim = None

        def stage_rhs(u):
            r = rhs(u, self._k if self._has_ramp else None, self._fluc)
            if self._forcing:
                # the body force, an (F, 1) column (ref:src/eles.cpp:
                # 1095-1247 adds the source to every stage's rhs)
                with tracing.part("residual.divergence"):
                    for i, v in enumerate(self._views(r)):
                        v.add_(self._bf_on(i, v))
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
        # the body-force column, written by every step
        self._bf = torch.zeros((nF, 1), dtype=dt_, device=dev)
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
        # per block with inflow faces: (block, the weights w * tdA and the
        # opp_0 extrapolation to the plane folded into one (U, E) weight
        # plane W: sum_s w_s u_f(s) = sum_{u,e} W[u, e] u[u, e]; for the
        # host's mass-flux line, the inflow elements and their columns of
        # W in float64)
        self._force = []
        for i, sl in enumerate(slots):
            if not sl:
                continue
            b, fs = blocks[i], np.concatenate(sl)
            Pf = b.ops.n_fpts
            wdA = b.ops.fpt_weights[fs % Pf] * b.tdA_fpts[fs]
            W = np.zeros((b.ops.n_upts, b.n_eles))
            np.add.at(W.T, fs // Pf, wdA[:, None] * b.ops.opp_0[fs % Pf])
            cols = np.unique(fs // Pf)
            di = self._devs[i]
            self._force.append((
                i, torch.as_tensor(W, dtype=dt_, device=di),
                torch.as_tensor(cols, device=di),
                torch.as_tensor(W[:, cols], dtype=torch.float64, device=di)))
        e1 = torch.zeros((nF, 1), dtype=dt_, device=dev)
        e1[1] = 1.0
        eE = torch.zeros((nF, 1), dtype=dt_, device=dev)
        eE[d + 1] = 1.0
        self._force_e = (e1, eE)

    def _bf_on(self, i, v):
        """The body-force column that block i's rhs ``v`` adds."""
        return self._bf.to(v.device)

    def _n_cards(self):
        """The cards the blocks sit on."""
        return len(set(self._devs))

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
        self._put("u_soa", self._from_numpy(_per_block(u)))
        self._put("reg_soa", self._from_numpy(_per_block(reg)))
        self.time = float(time)
        scalar = lambda v: torch.tensor(float(v), dtype=self.dtype,
                                        device=self.device)
        p = self.p
        if mdot_old is None:
            mdot_old = p.body_force_mdot0 if self._forcing else 0.0
        self._put("_k", scalar(iter_k))
        self._put("_mdot_old", scalar(mdot_old))
        self._put("_t_sim", scalar(t_sim))
        if self._avg:
            K = len(p.average_fields)
            if u_avg is None:
                u_avg = [np.zeros((E, U, K)) for U, E in self._shapes]
            self._put("u_avg_soa", self._from_numpy(_per_block(u_avg), K))

    def _put(self, name, value):
        """Bind the step's buffer ``name`` to ``value`` the first time, and
        afterwards copy ``value`` into it: a captured step keeps reading
        the buffers it was captured with."""
        buf = getattr(self, name)
        if buf is None:
            setattr(self, name, value)
        else:
            buf.copy_(value)

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

    def _sensor_of(self, i):
        """Block i's shock sensor as a diagnostic: an (E_t, U_t, F) array ->
        the Persson sensor (E_t,) numpy, from the capture's own sensor
        (solver.py:196-205 and multiblock.py:505-525 of the JAX
        package)."""
        sensor = self._caps[i].sensor
        return lambda u: sensor(euf_to_ufe(u, self.device, self.dtype)
                                ).cpu().numpy()

    def _local_dt(self, dt):
        """A per-element dt -> (the tensor the RK update broadcasts, its
        minimum as a 0-d tensor on the solver's device); the solver's
        subclass says which it takes."""
        raise NotImplementedError(
            f"hifiles_tpu_torch {type(self).__name__}: a per-element dt; "
            "the JAX MixedSolver steps every deck with one global dt "
            "(multiblock.py:843-874)")

    @property
    def capture_seconds(self):
        """Host seconds of the last capture of the step (its
        ``run.capture`` span), or None before the first."""
        sp = self._capture_span
        return None if sp is None else sp.seconds

    @tracing.traced("run")
    def run(self, n_steps: int, dt=None, graph: bool = True):
        """Advance n_steps RK steps of size dt (default: compute_dt()) and
        return the state tensor.  ``dt`` is a float, a 0-d tensor, or (on
        Solver) an (E,) array of per-element steps, dt_type 2's local dt:
        the RK update takes it per element, while body forcing, the
        averages and the inlet take its minimum, on the device, and the
        clock that minimum read once per call (solver.py:615-641 of the
        JAX package).  The turbulent inlet advances once per step, at
        stage 0, after the SVV pre-step, from the state's flux-point rows
        (solver.py:413-425; ref:src/solver.cpp:111-118); its fluctuations
        hold for the step's stages.

        On the card the steps run through ``_make_run_chunk``, one step
        captured as a CUDA graph and replayed (``run_path`` ends in
        "captured"); ``graph=False`` runs the same step eagerly, for
        comparisons and profiles ("eager").  On the CPU the run is eager.
        With shards on N > 1 cards the path ends in "(shards on N
        cards)", and each card replays its own segments of the step
        (ShardedLoop, parallel/cards.py)."""
        dt = self.compute_dt() if dt is None else dt
        dt_min = self._load_dt(dt)
        chunk = self._make_run_chunk() if graph else None
        path = "SoA featured (fast)" if self._featured or \
            self.turb_inlet is not None else "SoA (fast)"
        n = self._n_cards()
        self.run_path = path + (" captured" if chunk is not None else
                                " eager") + (f" (shards on {n} cards)"
                                             if n > 1 else "")
        if self.run_path not in self._logged:
            self._logged.add(self.run_path)
            _log_run_path(type(self).__name__, self.run_path)
        if chunk is not None:
            chunk(n_steps)
        else:
            for _ in range(n_steps):
                self._stage_draws()
                self._step_body()
        self.time += dt_min * n_steps
        return self.u_soa

    def _load_dt(self, dt):
        """Copy ``dt`` into the step's dt buffers: ``_dt_s``, 0-d in the
        state's dtype, the step's dt (a local dt's minimum), and
        ``_dt_rk``, what the RK update takes (``_dt_s`` itself, a (1, 1, E)
        plane, or per shard), allocated anew, and the captured step
        dropped, when dt's kind changes.  Returns dt (its minimum) as a
        float, the clock's step."""
        rk, low = (self._local_dt(dt) if getattr(dt, "ndim", 0) >= 1
                   else (None, dt))
        if rk is None:
            kind = "global"
        elif isinstance(rk, torch.Tensor):
            kind = tuple(rk.shape)
        else:
            kind = tuple(tuple(x.shape) for x in rk.parts)
        if kind != self._dt_kind:
            self.release_graph()
            self._dt_kind = kind
            self._dt_rk = (self._global_dt_rk() if rk is None
                           else rk.clone())
        if isinstance(low, torch.Tensor):
            self._dt_s.copy_(low)
        else:
            self._dt_s.fill_(float(low))
        if rk is not None:
            self._dt_rk.copy_(rk)
        elif self._dt_rk is not self._dt_s:
            self._dt_rk.copy_(self._dt_s)
        return float(low)

    def _global_dt_rk(self):
        """What the RK update takes for a global dt: ``_dt_s``."""
        return self._dt_s

    def _stage_draws(self):
        """Before each step, outside it: a ReplayDraws inlet copies the
        step's draws to the device (turb_inlet.ReplayDraws.stage)."""
        if self._ti_state is not None:
            stage = getattr(self._ti_state[2], "stage", None)
            if stage is not None:
                stage(self.turb_inlet.draw_shapes)

    def _step_body(self):
        """One time step on the step's buffers, which it updates in place
        and never rebinds: what the CUDA graph holds (solver.py:380-482 of
        the JAX package, the scan's body), its operations in the parts
        (tracing.part) step.pre, the residual's, step.update (step.py) and
        step.post."""
        dt = self._dt_s
        with tracing.part("step.pre"):
            if self._pre_step is not None:
                self._pre_step(self.u_soa)
            if self.turb_inlet is not None:
                pos, sgn, _ = self._ti_state
                (new_pos, new_sgn, _), fluc = self.turb_inlet.update(
                    self._ti_state, self._fpt_rows(self.u_soa), dt)
                if new_pos is not pos:
                    pos.copy_(new_pos)
                    sgn.copy_(new_sgn)
                self._fluc.copy_(fluc)
            if self._forcing:
                self._bf.copy_(self._body_force(self.u_soa, dt))
        self._step(self.u_soa, self.reg_soa, self._dt_rk)
        if self._featured:
            with tracing.part("step.post"):
                self._t_sim += dt
                self._k += 1.0
                if self._avg:
                    self._average(dt)

    def _graph_maker(self):
        """What makes the captured step's graph from its generators: the
        test's stand-in ``_step_graph`` where one is set, else
        graph.CudaStepGraph on the card; None where the run is eager (the
        CPU, or blocks on several devices)."""
        if self._step_graph is not None:
            return lambda gens: self._step_graph(self.device, gens)
        if self.device.type != "cuda" or set(self._devs) != {self.device}:
            return None
        return lambda gens: CudaStepGraph(self.device, gens)

    def _card_replicas(self):
        """Before the replays and after a capture: the cards' copies of
        the step's scalars refreshed (ShardedLoop's, with shards on
        several cards); nothing on one card."""

    def _make_run_chunk(self):
        """The counterpart of the JAX ``_make_run_chunk`` (solver.py:
        279-482, multiblock.py:724-840): ``chunk(n_steps)`` advances
        n_steps steps as replays of one captured step, or None where the
        run is eager (the CPU).  The graph comes from ``_graph_maker``: on
        one card a CUDA graph of the whole step, with shards on several
        the step captured per card (ShardedLoop).

        The first call captures: one warm-up step runs eagerly on the
        capture stream (it loads the kernels' instantiations and cuBLAS's
        handles and workspace) and counts as the chunk's first step; then
        the step is captured, which runs nothing, and replayed for the
        others, with no host sync between replays.  The step is captured
        anew only when its structure changes: dt's kind (global or per
        element) or the inlet's draw object.  ``captures`` and
        ``replays`` count them.  A ReplayDraws inlet stages each step's
        draws before its replay.  The hand kernels' launches held by the
        capture (tracing.capture) count once per replay
        (tracing.replay).  The spans run.warm_up, run.capture and
        run.replays time the three."""
        make = self._graph_maker()
        if make is None:
            return None
        draws = None if self._ti_state is None else self._ti_state[2]
        key = (self._dt_kind, draws)
        if self._graph is not None and self._graph_key != key:
            self.release_graph()

        def chunk(n_steps):
            left = n_steps
            self._card_replicas()
            if self._graph is None and left > 0:
                with tracing.span("run.warm_up"):
                    gen = getattr(draws, "gen", None)
                    g = make([] if gen is None else [gen])
                    self._stage_draws()
                    g.warm_up(self._step_body)
                left -= 1
                with tracing.span("run.capture") as self._capture_span:
                    g.capture(lambda: self._counted_step(g))
                self._graph, self._graph_key = g, key
                self.captures += 1
                # a stand-in's capture runs the program and returns the
                # state; the cards' copies follow it
                self._card_replicas()
            with tracing.span("run.replays"):
                for _ in range(left):
                    self._stage_draws()
                    self._graph.replay(self._step_body)
                    tracing.replay(self._graph_launches)
            self.replays += left
        return chunk

    def _counted_step(self, g):
        """The step as the graph ``g`` captures it: inside
        tracing.capture, its parts' nodes counted by ``g.count_nodes``
        where the graph has one (graph.CudaStepGraph; a test's stand-in
        may), its launches held for the replays."""
        with tracing.capture(getattr(g, "count_nodes", None)) as held:
            self._step_body()
        self._graph_launches = held

    def release_graph(self):
        """Drop the captured step and the memory its graph holds; the next
        captured run captures anew."""
        g, self._graph = self._graph, None
        if g is not None:
            g.release()

    def snapshot(self):
        """A copy of what a run advances: the state, RK register and clock,
        and the featured carry (ramp counter, mass-flux memory, averaging
        time, averages, the inlet's eddies and draw state), as bench.py's
        _snapshot takes the JAX solver's (bench.py:175-197)."""
        c = lambda t: None if t is None else t.clone()
        ti = None
        if self._ti_state is not None:
            pos, sgn, draws = self._ti_state
            ti = (pos.clone(), sgn.clone(), draws, draws.get_state())
        return dict(u=c(self.u_soa), reg=c(self.reg_soa), time=self.time,
                    k=c(self._k), mdot=c(self._mdot_old), t_sim=c(self._t_sim),
                    avg=c(self.u_avg_soa), ti=ti)

    def restore(self, snap):
        """Return to a ``snapshot()`` (which stays usable), copying into
        the step's buffers."""
        for name, key in (("u_soa", "u"), ("reg_soa", "reg"), ("_k", "k"),
                          ("_mdot_old", "mdot"), ("_t_sim", "t_sim"),
                          ("u_avg_soa", "avg")):
            if snap[key] is not None:
                getattr(self, name).copy_(snap[key])
        self.time = snap["time"]
        if snap["ti"] is not None:
            pos, sgn, draws, state = snap["ti"]
            cur_pos, cur_sgn, _ = self._ti_state
            cur_pos.copy_(pos)
            cur_sgn.copy_(sgn)
            draws.set_state(state)
            self._ti_state = (cur_pos, cur_sgn, draws)

    def _body_force(self, u, dt):
        """Channel/hill bulk-momentum forcing (solver.py:427-445;
        ref:src/eles.cpp:5281-5484 evaluate_body_force): the (F, 1) source
        column from the mass flux through the -x inflow plane, and the
        mass-flux memory updated, on the device; the blocks' plane
        integrals are summed on the solver's device."""
        views = self._views(u)
        acc = None
        for i, W, _, _ in self._force:
            part = (W[:, None] * views[i][:, :2]).sum(dim=(0, 2)).to(
                self.device)
            acc = part if acc is None else acc + part
        return self._force_column(acc, dt, self._mdot_old, self._force_e)

    def _force_column(self, acc, dt, mdot, e):
        """The body-force column from the summed plane integrals ``acc``
        (rho_int, mflux), dt, the mass-flux memory ``mdot`` (updated) and
        the unit columns ``e``, on their device."""
        p = self.p
        rho_int, mflux = acc
        ubulk = torch.where(rho_int == 0, 0.0, mflux / rho_int)
        area = p.body_force_area
        if p.body_force_type == 1:
            bf1 = (p.body_force_mdot0 - mflux) / (area * dt)
        else:
            bf1 = (p.body_force_mdot0 - 2.0 * mflux + mdot) / (area * dt)
        mdot.copy_(mflux)
        e1, eE = e
        return e1 * bf1 + eE * (bf1 * ubulk)

    def _average(self, dt):
        """Running average after the step (solver.py:451-471;
        ref:src/eles.cpp:5676-5698), block by block."""
        t_rel = self._t_sim - self.p.spinup_time
        a = (t_rel - dt) / t_rel
        b = dt / t_rel
        for u, avg in zip(self._views(self.u_soa),
                          self._views(self.u_avg_soa,
                                      len(self.p.average_fields))):
            on = lambda x: x.to(u.device)
            self._average_block(u, avg, lambda: (on(t_rel) <= on(dt), on(a),
                                                 on(b)))

    def _average_block(self, u, avg, coef):
        """One block's running averages ``avg`` from its state ``u``:
        the current values where ``first``, else a * avg + b * current,
        (first, a, b) = coef()."""
        d, fields = self.n_dims, self.p.average_fields
        rho = u[:, 0]
        col = {"rho_average": lambda: rho,
               "u_average": lambda: u[:, 1] / rho,
               "v_average": lambda: u[:, 2] / rho,
               "w_average": lambda: u[:, 3] / rho,
               "e_average": lambda: u[:, d + 1] / rho}
        cur = torch.stack([col[f_]() for f_ in fields], dim=1)
        first, a, b = coef()
        avg.copy_(torch.where(first, cur, a * avg + b * cur))

    @tracing.traced("massflux")
    def inflow_massflux(self):
        """(mass_flux, ubulk, next body force) through the -x cyclic
        inflow plane, summed over the blocks on the host (solver.py:
        689-711, multiblock.py:876-901; the rows of the reference's
        massflux.dat, ref:src/eles.cpp:5430-5453).  The body-force value
        is the one the next step applies from this state; None without
        forcing.  The plane integrals run on the device in float64 over
        the inflow elements alone, the folded weights W of the step's
        forcing (_setup_featured); two numbers cross to the host."""
        if not self._forcing:
            return None
        views = self._views(self.u_soa)
        acc = None
        for i, _, cols, W in self._force:
            u = views[i][:, :2].index_select(2, cols).to(torch.float64)
            part = (W[:, None] * u).sum(dim=(0, 2)).to(self.device)
            acc = part if acc is None else acc + part
        rho_int, mflux = acc.tolist()
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
        are sqrt() for L2 outside.  The gradient row stays zero here, as on
        the JAX MixedSolver (multiblock.py:929-949); Solver fills it."""
        p = self.p
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

    def _monitor_residual(self, norm_type):
        """The residual of the current state reduced on each block's
        device to one float64 number a field (sum |r|, sum r^2 or max |r|
        over the block's points, history.CHUNK elements a pass), issued
        (span monitor.residual), then waited for and copied to the host
        (monitor.to_host): a (blocks, F) array, and the points summed."""
        with tracing.span("monitor.residual"):
            parts, n_pts = [], 0
            for v in self._views(self._rhs(self.u_soa, None)):
                n_pts += v.shape[0] * v.shape[2]
                acc = torch.zeros(v.shape[1], dtype=torch.float64,
                                  device=v.device)
                for e0 in range(0, v.shape[2], CHUNK):
                    x = v[:, :, e0:e0 + CHUNK].to(torch.float64)
                    if norm_type == 1:
                        acc = acc + x.abs().sum(dim=(0, 2))
                    elif norm_type == 2:
                        acc = acc + x.square().sum(dim=(0, 2))
                    else:
                        acc = torch.maximum(acc, x.abs().amax(dim=(0, 2)))
                parts.append(acc)
        with tracing.span("monitor.to_host"):
            return np.stack([x.cpu().numpy() for x in parts]), n_pts

    def _check_cfl_dt(self):
        """The CFL time step reads |v| + c, which equation 1's one scalar
        field does not hold: the JAX package's compute_dt returns NaN for
        dt_type 1 and 2 there (models/euler.py:53-57 reads a pressure from
        the scalar), and the port refuses."""
        if self.p.equation == 1:
            raise ValueError(
                f"compute_dt: dt_type {self.p.dt_type} needs |v| + c, which "
                "advection-diffusion (equation 1) does not have; the JAX "
                "package's compute_dt returns NaN here; use dt_type 0")

    def residual_norm(self, norm_type: int = 2, r=None) -> np.ndarray:
        """Residual norm over every block's solution points with the
        reference's normalization (ref:src/output.cpp:2166-2247): L1 =
        sum|r|/n_pts, L2 = sqrt(sum r^2)/n_pts, inf = max|r|.  ``r``: the
        (E, U, F) residual per block (default: the current state's, whose
        sums run on its device).  Accumulates in f64 like the reference's
        double accumulators."""
        if r is None:
            parts, n_pts = self._monitor_residual(norm_type)
            with tracing.span("monitor.norm"):
                if norm_type == 1:
                    return parts.sum(axis=0) / n_pts
                if norm_type == 2:
                    return np.sqrt(parts.sum(axis=0)) / n_pts
                return parts.max(axis=0)
        with tracing.span("monitor.norm"):
            rs = [np.asarray(x, dtype=np.float64) for x in _per_block(r)]
            n_pts = sum(x.shape[0] * x.shape[1] for x in rs)
            if norm_type == 1:
                return sum(np.abs(x).sum(axis=(0, 1)) for x in rs) / n_pts
            if norm_type == 2:
                return np.sqrt(sum((x * x).sum(axis=(0, 1))
                                   for x in rs)) / n_pts
            return np.max([np.abs(x).max(axis=(0, 1)) for x in rs], axis=0)


class Solver(BlockLoop):
    """Single-element-type (quad, tri, hex or tet), single-device solver
    on ``device`` ("cuda", the default, or "cpu"), taking the port's own
    RunInput and MeshData (convert.run_input_from and convert.mesh_from
    turn the JAX package's into these).  Prisms and mixed meshes run
    through MixedSolver."""

    @tracing.traced("setup")
    def __init__(self, run_input: RunInput, mesh: MeshData, device="cuda",
                 dtype=torch.float64):
        self._setup(run_input, mesh, device, dtype, _unsupported)
        with tracing.span("setup.geometry"):
            self.ops = build_ops(run_input, int(mesh.ctype[0]))
            self.block = build_element_block(
                mesh, self.conn, self.ops, delta_cyclic=self.delta_cyclic,
                over_int_order=(run_input.over_int_order
                                if run_input.over_int else None))
        if needs_wall_distance(run_input):
            with tracing.span("setup.wall_distance"):
                b = self.block
                b.compute_wall_distance(wall_points(
                    b.bdy_slot, b.bdy_mask, b.bdy_bcid, b.pos_fpts,
                    self._bc_flags, self.n_dims))

        self._bc_fns = None
        tracing.counter("boundary_faces", self.block.bdy_slot.shape[0])
        if self.block.bdy_slot.size:
            with tracing.span("setup.boundary"):
                self._bc_fns = make_bc_functions(run_input, self.block,
                                                 self.rcfg, self.device,
                                                 dtype)
        with tracing.span("setup.residual"):
            self.residual_soa = make_residual_soa(self.block, self.rcfg,
                                                  self.device, dtype,
                                                  self._bc_fns)
        with tracing.span("setup.loop"):
            # the boundary planes are (nfp, Fb): face f's point j at
            # j*Fb + f
            Fb, nfp = self.block.bdy_slot.shape
            self._setup_inlet(self.block, np.arange(nfp)[None, :] * Fb
                              + np.arange(Fb)[:, None], (nfp, Fb),
                              self.residual_soa.flux_point_rows)
            self._setup_loop([self.block], [np.arange(mesh.n_cells)],
                             lambda u, ramp, fluc=None: self.residual_soa(
                                 u, fluc, ramp))
            self.sensor_fn = (self._sensor_of(0) if run_input.shock_cap
                              else None)
            self._h_ref = torch.as_tensor(self.block.h_ref, dtype=dtype,
                                          device=self.device)

        # initial condition at solution points (ref:src/solver.cpp:321-340)
        with tracing.span("setup.initial_state"):
            u0 = initial_condition(run_input, self.block.pos_upts,
                                   self.n_fields)
            if run_input.patch:
                u0 = apply_patch(run_input, self.block.pos_upts, u0)
            self.set_state(u0, np.zeros_like(u0), 0.0)

    @staticmethod
    def _state_out(arrays):
        """The one block's array."""
        return arrays[0]

    @tracing.traced("compute_dt")
    def compute_dt(self):
        """The time step (solver.py:570-613 of the JAX package;
        ref:src/solver.cpp:484-549, ref:src/eles.cpp:1267-1356): dt_type
        0 the deck's dt; else the CFL limit per element from h_ref and the
        largest |v| + c, and with viscosity the viscous limit
        max(4/3, gamma/Pr) mu/rho, computed on the device in the state's
        dtype: dt_type 1 their global minimum as a 0-d tensor, dt_type 2
        the per-element (E,) tensor.  Equation 1 takes dt_type 0 only
        (``_check_cfl_dt``)."""
        p = self.p
        if p.dt_type == 0:
            return p.dt
        self._check_cfl_dt()
        dt_ele = cfl_dt(p, self.u_soa, self._h_ref, self.n_dims)
        return dt_ele if p.dt_type == 2 else dt_ele.min()

    def _local_dt(self, dt):
        """An (E,) per-element dt -> ((1, 1, E) in the state's dtype on the
        device, broadcast along the (U, F, E) state as the JAX chunk does,
        solver.py:302-303; its minimum, 0-d)."""
        E = self.block.n_eles
        dt = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        if dt.shape != (E,):
            raise ValueError(f"local dt of shape {tuple(dt.shape)}; the "
                             f"block has {E} elements")
        return dt.view(1, 1, E), dt.min()

    def gradient_fn(self, u) -> np.ndarray:
        """The LDG-corrected physical gradient at the solution points of an
        (E, U, F) state, as (E, U, F, d) numpy in the state's dtype
        (residual.py:508-547 and solver.py:559-567 of the JAX package): the
        residual's own gradient stage (residual_soa.make_face_residual),
        boundaries through bc_fns.ldg_solution."""
        gr = self.residual_soa.gradient(euf_to_ufe(u, self.device,
                                                   self.dtype))
        return np.ascontiguousarray(gr.permute(3, 1, 2, 0).cpu().numpy())

    def compute_error(self, norm_type: int | None = None,
                      u_grad=None) -> np.ndarray:
        """BlockLoop.compute_error with the gradient error row of the
        viscous test cases (solver.py:644-687 of the JAX package;
        ref:src/eles.cpp:5109-5123, 5185-5280): field 0 only for test
        cases 2 and 3, every field for 5 (Couette).  ``u_grad``, an
        (E, U, F) state, is the one whose gradient is held against the
        analytic one (default: the current state); the reference uses the
        last RK stage's input state."""
        out = super().compute_error(norm_type)
        p = self.p
        if not (p.viscous and p.test_case in (2, 3, 5)):
            return out
        norm_type = norm_type if norm_type is not None else p.error_norm_type
        b, ops = self.block, self.ops
        grad_u = np.asarray(self.gradient_fn(self.u if u_grad is None
                                             else u_grad), dtype=np.float64)
        grad_cub = np.einsum("cu,eufd->ecfd", ops.opp_vol_cubpts, grad_u)
        _, grad_a = analytic_solution(p, b.pos_vol_cubpts, self.time,
                                      self.n_fields)
        gerr = grad_cub - grad_a
        if p.test_case in (2, 3):
            gerr = gerr[..., :1, :]
        w = ops.w_vol_cubpts[None, :] * b.detjac_vol_cubpts
        if norm_type == 1:
            row = np.einsum("ec,ecfd->f", w, np.abs(gerr))
        else:
            row = np.einsum("ec,ecfd->f", w, gerr * gerr)
        out[1, :row.shape[0]] = row
        return out
