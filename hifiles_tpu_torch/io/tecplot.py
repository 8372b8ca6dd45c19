"""Tecplot ASCII writer (write_type 1, ref:src/output.cpp:165-460
write_tec).

One FEPOINT zone per element type holding all elements' plot points and
sub-cell connectivity; variables are coordinates, conserved fields, then
time-averaged and diagnostic fields, matching the reference's header
(ref:src/output.cpp:242-290).

Copied from hifiles_tpu/io/tecplot.py (lines 1-87) unchanged but for this
paragraph and one repair: the gradient the diagnostics read is computed for
``scaled_q_criterion`` too, which the JAX writer leaves out (:40-41), so
that field asked alone no longer raises.
"""

from __future__ import annotations

import os

import numpy as np

from .vtu import _plot_points, diagnostic_fields

def _zonetype(nd: int, nvpc: int) -> str:
    if nd == 2:
        return "FETRIANGLE" if nvpc == 3 else "FEQUADRILATERAL"
    return "FETETRAHEDRON" if nvpc == 4 else "FEBRICK"


def write_tec(solver, directory: str, step: int, rank: int = 0) -> str:
    p = solver.p
    nd = solver.n_dims
    name = p.data_file_name
    fname = os.path.join(directory, f"{name}_{step:09d}_p{rank:04d}.plt")

    pts_ref, subconn, _ = _plot_points(solver.ops.ele_type, p.p_res)
    opp_p = solver.ops.interp_to(pts_ref)
    u = np.asarray(solver.u, dtype=np.float64)
    u_ppts = np.einsum("pu,euf->epf", opp_p, u)

    from ..mesh.shape import shape_basis
    from ..solver.elements import mesh_shape_points
    spts, n_spts = mesh_shape_points(solver.mesh)
    sb = shape_basis(solver.ops.ele_type, pts_ref, n_spts)
    pos = np.einsum("ps,esd->epd", sb, spts)

    need_grad = any(f in ("vorticity", "q_criterion", "scaled_q_criterion")
                    for f in p.diagnostic_fields)
    grad_ppts = None
    if need_grad:
        U = solver.ops.n_upts
        tgrad = np.einsum("kgu,euf->ekfg",
                          solver.ops.opp_2_cat.reshape(U, nd, U), u)
        grad = np.einsum("euml,eufm->eufl", solver.block.jginv_upts,
                         tgrad) / solver.block.detjac_upts[..., None, None]
        grad_ppts = np.einsum("pu,eufd->epfd", opp_p, grad)
    diag = diagnostic_fields(solver, u_ppts, grad_ppts, p.diagnostic_fields)

    avg_cols = {}
    if p.average_fields and solver.u_avg is not None:
        avg_ppts = np.einsum("pu,euf->epf", opp_p,
                             np.asarray(solver.u_avg, dtype=np.float64))
        for i, f_ in enumerate(p.average_fields):
            avg_cols[f_] = avg_ppts[..., i]

    coords = ["x", "y", "z"][:nd]
    if p.equation == 0:
        cons = (["rho", "mom_x", "mom_y", "rhoE"] if nd == 2
                else ["rho", "mom_x", "mom_y", "mom_z", "rhoE"])
        if p.RANS:
            cons.append("mu_tilde")
    else:
        cons = ["rho"]
    names = coords + cons + list(avg_cols) + list(diag)

    E, P = u_ppts.shape[:2]
    nsub = subconn.shape[0]
    cols = [pos[..., i] for i in range(nd)]
    cols += [u_ppts[..., i] for i in range(len(cons))]
    cols += [avg_cols[f_] for f_ in avg_cols]
    cols += [diag[f_] for f_ in diag]
    table = np.stack([c.reshape(-1) for c in cols], axis=-1)

    with open(fname, "w") as f:
        f.write('Title = "HiFiLES Solution"\n')
        f.write("Variables = " + ", ".join(f'"{v}"' for v in names) + "\n")
        f.write(f"ZONE N = {E * P}, E = {E * nsub}, "
                f"DATAPACKING = POINT, ZONETYPE = "
                f"{_zonetype(nd, subconn.shape[1])}\n")
        np.savetxt(f, table, fmt="%.15g")
        conn = (subconn[None] + (np.arange(E) * P)[:, None, None]
                ).reshape(-1, subconn.shape[1]) + 1    # 1-based
        np.savetxt(f, conn, fmt="%d")
    return fname
