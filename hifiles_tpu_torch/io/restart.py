"""HDF5 restart files, layout-compatible with the reference
(ref:src/output.cpp:1822-1912 write_restart_hdf5,
ref:src/solver.cpp:436-482 read; per-type info datasets
ref:src/eles_quads.cpp:727-756).

File ``Rest_%09d.h5``: scalar attrs ``nd_time`` (f64) and ``order`` (i32);
dataset ``data`` of shape (n_fields, num_cells_global, n_upts) float64
indexed by *global* cell id (rank-count independent); one dataset per
element type present ("TRIS"/"QUADS"/"TETS"/"PRIS"/"HEXAS") holding the 1-D
solution-point coordinates (tensor types) used for cross-order
re-interpolation on read (opp_r, ref:src/eles.cpp:3692-3710).

Copied from hifiles_tpu/io/restart.py unchanged but for this paragraph and
the readers' last step: a reader hands the state to ``solver.set_state(u,
zeros, time)``, which also clears the RK register and resets the featured
carry (the ramp counter to 1, the forcing's mass-flux memory to
body_force_mdot0, the averaging time and the averages to 0), as a freshly
built JAX solver holds them after its read.  The operators of a
cross-order read come from the port's solver.build_ops.  The SEM eddy
restart (:179-227) writes the same bytes; its reader keeps the inlet's
draw object where the JAX reader keeps its key.
"""

from __future__ import annotations

import os

import numpy as np

from .. import HEX, PRISM, QUAD, TET, TRI

TYPE_DSET = {TRI: "TRIS", QUAD: "QUADS", TET: "TETS", PRISM: "PRIS",
             HEX: "HEXAS"}


def restart_filename(directory: str, step: int) -> str:
    return os.path.join(directory, f"Rest_{step:09d}.h5")


def _type_info(ops, order):
    if ops.ele_type in (QUAD, HEX):
        return ops.loc_upts[:order + 1, 0]
    return ops.loc_upts.ravel()


def write_restart(path: str, solver, step: int | None = None) -> str:
    """Write the solver state; returns the file path.

    Mixed meshes write one dataset sized by the largest present type's
    n_upts; each type hyperslab-writes its own columns by global cell id
    (exactly the reference's layout, ref:src/output.cpp:1841-1875)."""
    import h5py

    if step is not None:
        path = restart_filename(path, step)
    icg = solver.mesh.ic2icg
    n_global = int(icg.max()) + 1

    with h5py.File(path, "w") as f:
        f.attrs["nd_time"] = np.float64(solver.time)
        f.attrs["order"] = np.int32(solver.p.order)
        if hasattr(solver, "cts"):           # MixedSolver
            F = solver.n_fields
            U_max = max(solver.blocks[ct].ops.n_upts for ct in solver.cts)
            dset = f.create_dataset("data", (F, n_global, U_max),
                                    dtype=np.float64)
            for ct, u in zip(solver.cts, solver.u):
                ub = np.asarray(u, dtype=np.float64)
                gids = icg[solver.mt.sels[ct]]
                # h5py hyperslab selections must be increasing; sels is
                # signature-ordered (mixed_type_selections), so sort the
                # ids and permute the data to match
                o = np.argsort(gids)
                dset[:, gids[o], :ub.shape[1]] = ub.transpose(2, 0, 1)[:, o]
                f.create_dataset(
                    TYPE_DSET[ct],
                    data=np.asarray(_type_info(solver.blocks[ct].ops,
                                               solver.p.order),
                                    dtype=np.float64))
            return path
        u = np.asarray(solver.u, dtype=np.float64)      # (E, U, F)
        E, U, F = u.shape
        dset = f.create_dataset("data", (F, n_global, U), dtype=np.float64)
        # data[k, global_cell, upt] (ref write_restart_data_hdf5)
        dset[:, icg, :] = u.transpose(2, 0, 1)
        ct = solver.ops.ele_type
        f.create_dataset(
            TYPE_DSET[ct],
            data=np.asarray(_type_info(solver.ops, solver.p.order),
                            dtype=np.float64))
    return path


_TYPE_ELE_NAME = {TRI: "TRIS", QUAD: "QUADS", TET: "TETS", PRISM: "PRIS",
                  HEX: "HEXAS"}
_TYPE_FULL_NAME = {TRI: "triangular", QUAD: "quadrilateral",
                   TET: "tetrahedral", PRISM: "prismatic", HEX: "hexahedral"}


def write_restart_ascii(path: str, solver, step: int | None = None,
                        rank: int = 0) -> str:
    """ASCII restart ``Rest_%09d_p%04d.dat`` (ref:src/output.cpp:1753-1818
    write_restart_ascii, ref:src/eles.cpp:845-869 write_restart_data_ascii,
    ref:src/eles_quads.cpp write_restart_info_ascii)."""
    if step is not None:
        path = os.path.join(path, f"Rest_{step:09d}_p{rank:04d}.dat")
    u = np.asarray(solver.u, dtype=np.float64)
    E, U, F = u.shape
    icg = solver.mesh.ic2icg
    ct = solver.ops.ele_type
    p = solver.p
    with open(path, "w") as f:
        f.write(f"{float(solver.time)!r}\n")
        f.write(f"{_TYPE_ELE_NAME[ct]}\n")
        f.write("Order\n")
        f.write(f"{p.order}\n")
        f.write(f"Number of solution points per {_TYPE_FULL_NAME[ct]} "
                "element\n")
        f.write(f"{U}\n")
        f.write("Location of solution points\n")
        if ct in (QUAD, HEX):
            pts = solver.ops.loc_upts[:p.order + 1, 0]
        else:
            pts = solver.ops.loc_upts.ravel()
        f.write(" ".join(repr(float(x)) for x in pts) + "\n")
        f.write("n_eles\n")
        f.write(f"{E}\n")
        f.write("ele2global_ele hf_array\n")
        f.write(" ".join(str(int(g)) for g in icg) + "\n")
        f.write("data\n")
        for e in range(E):
            f.write(f"{int(icg[e])}\n")
            for j in range(U):
                f.write(" ".join(repr(float(u[e, j, k]))
                                 for k in range(F)) + "\n")
        f.write("\n")
    return path


def read_restart_ascii(path: str, solver) -> float:
    """Read an ASCII restart written by write_restart_ascii (matching the
    reference's reader contract, ref:src/eles.cpp:656-760)."""
    with open(path) as f:
        toks = f.read().split("\n")
    it = iter(toks)
    time = float(next(it))
    name = next(it).strip()
    ct = solver.ops.ele_type
    if name != _TYPE_ELE_NAME[ct]:
        raise ValueError(f"restart element section {name!r}; solver has "
                         f"{_TYPE_ELE_NAME[ct]}")
    assert next(it).strip() == "Order"
    order_rest = int(next(it))
    next(it)                       # 'Number of solution points...'
    U = int(next(it))
    next(it)                       # 'Location of solution points'
    next(it)                       # the points themselves
    assert next(it).strip() == "n_eles"
    E = int(next(it))
    next(it)                       # 'ele2global_ele hf_array'
    next(it)
    assert next(it).strip() == "data"
    F = solver.n_fields
    icg = solver.mesh.ic2icg
    g2l = {int(g): e for e, g in enumerate(icg)}
    # cross-order: re-interpolate each element's rows through opp_r
    # (the reference's universal path, ref:src/eles.cpp:3692-3712)
    opp_r = None
    if order_rest != solver.p.order:
        opp_r = restart_interp(solver.p, ct, order_rest,
                               solver.ops.loc_upts)
    u = np.asarray(solver.u, dtype=np.float64).copy()
    for _ in range(E):
        gid = int(next(it))
        rows = np.array([[float(x) for x in next(it).split()]
                         for _ in range(U)])
        if gid in g2l:
            vals = rows[:, :F]
            if opp_r is not None:
                vals = opp_r @ vals
            u[g2l[gid]] = vals
    solver.set_state(u, np.zeros_like(u), time)
    return time



def write_sem_restart(directory: str, step: int, turb_inlet,
                      ti_state, run_input) -> str:
    """SEM eddy-state restart ``sem_files/sem_files_%09d.dat``
    (ref:src/bdy_inters.cpp:2227-2276 write_sem_restart)."""
    bc = next(b for b in run_input.bc_list
              if getattr(b, "inlet_type", 0) == 2)
    d = os.path.join(directory, "sem_files")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"sem_files_{step:09d}.dat")
    eddy_pos = np.asarray(ti_state[0].cpu(), dtype=np.float64)
    sgn = np.asarray(ti_state[1].cpu(), dtype=np.float64)
    with open(path, "w") as f:
        f.write(f"{bc.mode}\n{float(bc.vis_y)!r}\n")
        if bc.mode == 0:
            f.write(f"{float(bc.turb_1)!r} {float(bc.turb_2)!r}\n")
        else:
            f.write(f"{float(bc.turb_1)!r}\n")
        f.write(f"{turb_inlet.n_eddy}\n")
        for row in eddy_pos:
            f.write(" ".join(f"{x:.12e}" for x in row) + "\n")
        for row in sgn:
            f.write(" ".join(str(int(x)) for x in row) + "\n")
    return path


def read_sem_restart(directory: str, step: int, solver) -> bool:
    """Load SEM eddy positions/signs into the solver's inlet state
    (ref:src/bdy_inters.cpp:2278-2320).  Returns False if absent."""
    import torch
    path = os.path.join(directory, "sem_files", f"sem_files_{step:09d}.dat")
    if not os.path.exists(path) or solver.turb_inlet is None:
        return False
    with open(path) as f:
        toks = f.read().split()
    it = iter(toks)
    mode = int(next(it))
    next(it)                           # vis_y
    next(it)                           # turb_1
    if mode == 0:
        next(it)                       # turb_2
    n_eddy = int(next(it))
    eddy = np.array([float(next(it)) for _ in range(3 * n_eddy)]
                    ).reshape(n_eddy, 3)
    sgn = np.array([float(next(it)) for _ in range(3 * n_eddy)]
                   ).reshape(n_eddy, 3)
    pos, signs, _ = solver._ti_state
    as_t = lambda a: torch.as_tensor(a, dtype=solver.dtype,
                                     device=solver.device)
    # into the inlet's own buffers, which a captured step reads
    pos.copy_(as_t(eddy))
    signs.copy_(as_t(sgn))
    return True


def restart_interp(run_input, ct: int, order_rest: int,
                   loc_upts_new: np.ndarray) -> np.ndarray:
    """opp_r: the restart file's nodal basis (order_rest, the run's point
    types) evaluated at the run's solution points — the universal
    cross-order re-interpolation operator (ref:src/eles.cpp:3692-3710).
    Works for all five element types via OpSet.interp_to."""
    import copy

    from ..solver.solver import build_ops
    p_rest = copy.copy(run_input)
    p_rest.order = order_rest
    return build_ops(p_rest, ct).interp_to(loc_upts_new)


def read_restart(path: str, solver) -> float:
    """Load state into the solver (re-interpolating across orders when the
    file's order differs); returns the non-dimensional time."""
    import h5py

    with h5py.File(path, "r") as f:
        time = float(f.attrs["nd_time"])
        order_rest = int(f.attrs["order"])
        data = f["data"][...]                       # (F, n_global, U_rest)

    icg = solver.mesh.ic2icg
    if hasattr(solver, "cts"):                      # MixedSolver
        us = []
        for ct in solver.cts:
            ops_b = solver.blocks[ct].ops
            gids = icg[solver.mt.sels[ct]]
            if order_rest != solver.p.order:
                import copy

                from ..solver.solver import build_ops
                p_rest = copy.copy(solver.p)
                p_rest.order = order_rest
                Ur = build_ops(p_rest, ct).n_upts
                opp_r = restart_interp(solver.p, ct, order_rest,
                                       ops_b.loc_upts)
                u_ct = np.einsum("vu,euf->evf", opp_r,
                                 data[:, gids, :Ur].transpose(1, 2, 0))
            else:
                u_ct = data[:, gids, :ops_b.n_upts].transpose(1, 2, 0)
            us.append(u_ct)
        solver.set_state(tuple(us), tuple(np.zeros_like(a) for a in us),
                         time)
        return time
    u = data[:, icg, :].transpose(1, 2, 0)          # (E, U_rest, F)

    if order_rest != solver.p.order:
        opp_r = restart_interp(solver.p, solver.ops.ele_type, order_rest,
                               solver.ops.loc_upts)   # (U_new, U_rest)
        u = np.einsum("vu,euf->evf", opp_r, u[:, :opp_r.shape[1], :])

    solver.set_state(u, np.zeros_like(u), time)
    return time
