"""Mixed-element-type solver: one block per element type, one global face
space.

Port of hifiles_tpu/solver/multiblock.py::MixedSolver (:383-959) with its
mixed SoA chunk (:724-792): the per-type blocks of
elements.build_mixed_blocks, the residual of residual_mixed_soa.py, the
turbulent inlet on the global slot space (_TIFacade), and the time loop,
featured carry (BC ramp counter, bulk-momentum forcing over each type's
-x cyclic slots, running averages) and diagnostics of
solver.BlockLoop, which Solver shares.  Pure-prism meshes run here too
(their tri and quad faces differ in size), as the JAX package's
command-line entry point routes them.  The state is one tensor holding each type's (U_t, F, E_t)
state in ``cts`` order; ``u`` gives them as (E_t, U_t, F) numpy arrays, in
the JAX MixedSolver's ``sels`` order.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import HEX, PRISM, QUAD, TET, TRI, tracing
from ..config.params import RunInput
from ..mesh.core import MeshData
from ..models.euler import max_wavespeed
from .bc import BCFunctions, use_wm_of, wall_models_on
from .elements import MixedMeshTables, build_mixed_blocks
from .ics import initial_condition
from .residual_mixed_soa import bdy_point_faces, make_mixed_residual_soa
from .solver import BlockLoop, build_ops, needs_wall_distance, wall_points


def _unsupported(p: RunInput, _mesh) -> list:
    """What MixedSolver does not run: ``patch``, which the JAX MixedSolver
    leaves unapplied (multiblock.py:544-548: its initial state is never
    patched, and its driver patches a restart only through a single-type
    solver's block, driver.py:137-143), so the port has no behaviour to
    hold it to."""
    missing = []
    if p.patch:
        missing.append("patch (the JAX MixedSolver leaves the initial and "
                       "restart states unpatched)")
    return missing


def build_mixed_wm_tables(mt: MixedMeshTables, use_wm_face: np.ndarray):
    """Wall-model input points on a mixed mesh: per wall-modeled boundary
    face, the owning block, local element, and the solution point of that
    element farthest (min-over-fpts normal distance) from the face
    (ref:src/eles.cpp:4873-4903 calc_wm_upts_dist; the reference wall-models
    any boundary face regardless of element type,
    ref:src/bdy_inters.cpp:1095-1131).

    Returns (per_ct, wm_dist): ``per_ct[ct] = (faces, ele, upt)`` int
    arrays over this block's wall-modeled faces; ``wm_dist`` (Fb,).
    Copied from hifiles_tpu/solver/multiblock.py:108-142."""
    Fb = mt.bdy_bcid.size
    wm_dist = np.ones(Fb)
    per_ct = {ct: ([], [], []) for ct in mt.cts}
    seg = {ct: (mt.slot_off[ct],
                mt.slot_off[ct] + mt.blocks[ct].n_eles
                * mt.blocks[ct].ops.n_fpts) for ct in mt.cts}
    for fi in range(Fb):
        if use_wm_face[fi] <= 0:
            continue
        slots = mt.bdy_slot[fi][mt.bdy_mask[fi] > 0]
        s0 = int(slots[0])
        ct = next(c for c in mt.cts if seg[c][0] <= s0 < seg[c][1])
        blk = mt.blocks[ct]
        e = (s0 - seg[ct][0]) // blk.ops.n_fpts
        fpt_pos = mt.pos_fpts[slots]
        fpt_nrm = mt.norm_fpts[slots]
        dvec = fpt_pos[None, :, :] - blk.pos_upts[e][:, None, :]
        dist = np.einsum("ufd,fd->uf", dvec, fpt_nrm).min(axis=1)
        per_ct[ct][0].append(fi)
        per_ct[ct][1].append(int(e))
        per_ct[ct][2].append(int(np.argmax(dist)))
        wm_dist[fi] = float(dist.max())
    per_ct = {ct: tuple(np.asarray(x, dtype=np.int64) for x in v)
              for ct, v in per_ct.items()}
    return per_ct, wm_dist


class _TIFacade:
    """Duck-typed block for turb_inlet.inlet_host_setup on the mixed
    GLOBAL slot space: per-slot quadrature weights and owning-cell size
    replace the single-type ``slots % Pf`` arithmetic.  Copied from
    hifiles_tpu/solver/multiblock.py:50-77."""

    _REF_VOL = {TRI: 2.0, QUAD: 4.0, TET: 4.0 / 3.0, PRISM: 4.0, HEX: 8.0}

    def __init__(self, mt: MixedMeshTables, run_input: RunInput):
        self.ops = mt.blocks[mt.cts[0]].ops       # n_dims only
        self.bdy_slot = mt.bdy_slot
        self.bdy_bcid = mt.bdy_bcid
        self.bdy_mask = mt.bdy_mask
        self.pos_fpts = mt.pos_fpts
        self.norm_fpts = mt.norm_fpts
        self.tdA_fpts = mt.tdA_fpts
        wq, ls = [], []
        for ct in mt.cts:
            b = mt.blocks[ct]
            o = b.ops
            wq.append(np.tile(o.fpt_weights, b.n_eles))
            # per-element cell-size metric (ref:src/eles.cpp:6023-6070)
            cell = (run_input.filter_ratio
                    * (self._REF_VOL[ct]
                       * b.detjac_upts.max(axis=1)) ** (1.0 / o.n_dims)
                    / (run_input.order + 1.0))
            ls.append(np.repeat(cell, o.n_fpts))
        self.slot_wq = np.concatenate(wq)
        self.slot_ls = np.concatenate(ls)


def mixed_bc_functions(run_input: RunInput, mt: MixedMeshTables, rcfg,
                       device, dtype, wm_tables=None) -> BCFunctions:
    """The boundary functions of a mixed mesh on ``device``: one plane
    column per boundary point (its faces differ in their point counts),
    each with its face's group and, with wall models (``wm_tables`` of
    build_mixed_wm_tables), its face's element, solution point and
    wall-model distance."""
    face = bdy_point_faces(mt)
    wm = None
    if wm_tables is not None:
        per_ct, wm_dist = wm_tables
        ele = np.zeros(mt.bdy_bcid.size, dtype=np.int64)
        upt = np.zeros(mt.bdy_bcid.size, dtype=np.int64)
        for faces, e, u in per_ct.values():
            ele[faces], upt[faces] = e, u
        wm = (ele[face], upt[face], wm_dist[face])
    return BCFunctions(run_input, mt.bdy_bcid[face],
                       mt.blocks[mt.cts[0]].ops.n_dims, rcfg, device, dtype,
                       wm)


class MixedSolver(BlockLoop):
    """Solver for meshes with more than one element type, or of prisms, on
    one device (``device`` "cuda", the default, or "cpu"); the interface of
    Solver (run, set_state, residual_norm, compute_error, compute_dt,
    inflow_massflux) with per-type tuples where Solver takes or gives one
    array, and ``sensor_fns`` per element type where Solver has
    ``sensor_fn``."""

    @tracing.traced("setup")
    def __init__(self, run_input: RunInput, mesh: MeshData, device="cuda",
                 dtype=torch.float64):
        self._setup(run_input, mesh, device, dtype, _unsupported)
        self.cts = cts = sorted(int(c) for c in np.unique(mesh.ctype))
        with tracing.span("setup.geometry"):
            self.ops_by_ct = {ct: build_ops(run_input, ct) for ct in cts}
            self.mt = mt = build_mixed_blocks(
                mesh, self.conn, self.ops_by_ct,
                over_int_order=(run_input.over_int_order
                                if run_input.over_int else None))
        self.blocks = mt.blocks

        # wall distance per block (multiblock.py:439-453;
        # ref:src/geometry.cpp:708-894)
        if needs_wall_distance(run_input):
            with tracing.span("setup.wall_distance"):
                pts = wall_points(mt.bdy_slot, mt.bdy_mask, mt.bdy_bcid,
                                  mt.pos_fpts, self._bc_flags, self.n_dims)
                for ct in cts:
                    self.blocks[ct].compute_wall_distance(pts)
        with tracing.span("setup.boundary"):
            # wall models on any boundary face, whatever its element type
            # (multiblock.py:474-482; ref:src/bdy_inters.cpp:1095-1131)
            self._wm_tables = None
            if wall_models_on(run_input, mt.bdy_bcid):
                self._wm_tables = build_mixed_wm_tables(
                    mt, use_wm_of(run_input, mt.bdy_bcid))
            self._bc_fns = None
            tracing.counter("boundary_faces", mt.bdy_slot.shape[0])
            if mt.bdy_slot.size:
                self._bc_fns = mixed_bc_functions(run_input, mt, self.rcfg,
                                                  self.device, dtype,
                                                  self._wm_tables)
        with tracing.span("setup.residual"):
            self.residual_soa = make_mixed_residual_soa(
                mt, self.rcfg, self.device, dtype, self._bc_fns,
                self._wm_tables)

        with tracing.span("setup.loop"):
            # the boundary planes are (1, Nb), one column per boundary
            # point (residual_mixed_soa.MixedSoaTables)
            pts = mt.bdy_mask > 0
            plane_index = -np.ones(mt.bdy_mask.shape, dtype=np.int64)
            plane_index[pts] = np.arange(int(pts.sum()))
            self._setup_inlet(_TIFacade(mt, run_input), plane_index,
                              (1, int(pts.sum())),
                              lambda u: self.residual_soa.flux_point_rows(
                                  self._views(u)))

            def rhs(u, ramp, fluc=None):
                out = self._alloc()
                self.residual_soa(self._views(u), fluc, ramp,
                                  out=self._views(out))
                return out
            blocks = [mt.blocks[ct] for ct in cts]
            self._setup_loop(blocks, [mt.sels[ct] for ct in cts], rhs)
            self.sensor_fns = ({ct: self._sensor_of(i) for i, ct in
                                enumerate(cts)} if run_input.shock_cap
                               else None)

        # initial condition at each block's solution points
        with tracing.span("setup.initial_state"):
            u0 = tuple(initial_condition(run_input, b.pos_upts,
                                         self.n_fields) for b in blocks)
            self.set_state(u0, tuple(np.zeros_like(a) for a in u0), 0.0)

    @tracing.traced("compute_dt")
    def compute_dt(self) -> float:
        """The time step by the JAX MixedSolver's rule (multiblock.py:
        843-853), which the port mirrors: dt_type 0 the deck's dt; else the
        inviscid CFL limit only (no viscous limit), its minimum over every
        block's elements as a float for dt_type 1 and 2 alike.  |v| + c is
        computed on the device in the state's dtype, the rest on the host
        in float64, as there."""
        p = self.p
        if p.dt_type == 0:
            return p.dt
        self._check_cfl_dt()
        dts = []
        for b, u in zip(self._blocks, self._views(self.u_soa)):
            lam = max_wavespeed(u.unbind(1), p.gamma, self.n_dims).amax(dim=0)
            dt_ele = (p.CFL * b.h_ref / lam.cpu().numpy()
                      / (2 * p.order + 1))
            dts.append(dt_ele.min())
        return float(min(dts))
