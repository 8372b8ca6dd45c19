"""ParaView XML output (ref:src/output.cpp:462-899 write_vtu).

Writes per-rank ``<name>_%09d/<name>_%09d_p%04d.vtu`` plus a rank-0
``.pvtu`` index, with the solution interpolated to a plot-point lattice
(opp_p, ref:src/eles.cpp:3600-3621) and the reference's diagnostic fields
(ref:src/eles.cpp:3858-4007): u/v/w, energy, pressure, mach, vorticity,
q_criterion, sensor.

Copied from hifiles_tpu/io/vtu.py (lines 1-317) unchanged but for this
paragraph and two repairs: the gradient the diagnostics read is computed for
``scaled_q_criterion`` too, which the JAX writer leaves out (:231-232), so
that field asked alone no longer raises; and ``diagnostic_fields`` returns
at once when no field is asked, where the JAX copy first reads a pressure
from the state and so fails on every advection-diffusion deck (one scalar
field) in the vtu and tecplot writers.  ``solver.sensor_fn`` is the port's
(an (E, U, F) array -> the (E,) sensor).
"""

from __future__ import annotations

import base64
import os

import numpy as np

from .. import HEX, PRISM, QUAD, TET, TRI

# VTK cell type codes
VTK_QUAD = 9
VTK_TRIANGLE = 5
VTK_HEXAHEDRON = 12
VTK_TETRA = 10
VTK_WEDGE = 13


def _plot_points(ele_type: int, p_res: int):
    """Plot lattice + sub-cell connectivity per element
    (ref:src/eles_quads.cpp:367-385 & :138-158, tri/hex analogs)."""
    lin = np.linspace(-1.0, 1.0, p_res)
    if ele_type == QUAD:
        X, Y = np.meshgrid(lin, lin, indexing="xy")
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)
        conn = []
        for k in range(p_res - 1):
            for l in range(p_res - 1):
                v0 = l + p_res * k
                conn.append([v0, v0 + 1, v0 + p_res + 1, v0 + p_res])
        return pts, np.array(conn), VTK_QUAD
    if ele_type == TRI:
        pts, conn = [], []
        idx = {}
        for j in range(p_res):
            for i in range(p_res - j):
                idx[(i, j)] = len(pts)
                pts.append((-1 + 2 * i / (p_res - 1),
                            -1 + 2 * j / (p_res - 1)))
        for j in range(p_res - 1):
            for i in range(p_res - 1 - j):
                conn.append([idx[(i, j)], idx[(i + 1, j)], idx[(i, j + 1)]])
                if i + j < p_res - 2:
                    conn.append([idx[(i + 1, j)], idx[(i + 1, j + 1)],
                                 idx[(i, j + 1)]])
        return np.array(pts), np.array(conn), VTK_TRIANGLE
    if ele_type == HEX:
        pts = np.array([(x, y, z) for z in lin for y in lin for x in lin])
        conn = []
        n = p_res
        for k in range(n - 1):
            for j in range(n - 1):
                for i in range(n - 1):
                    v = i + n * j + n * n * k
                    conn.append([v, v + 1, v + 1 + n, v + n,
                                 v + n * n, v + n * n + 1,
                                 v + n * n + 1 + n, v + n * n + n])
        return pts, np.array(conn), VTK_HEXAHEDRON
    if ele_type == TET:
        # barycentric lattice + standard tet/octahedron decomposition
        n = p_res
        pts, idx = [], {}
        for k in range(n):
            for j in range(n - k):
                for i in range(n - k - j):
                    idx[(i, j, k)] = len(pts)
                    pts.append((-1 + 2 * i / (n - 1), -1 + 2 * j / (n - 1),
                                -1 + 2 * k / (n - 1)))
        conn = []

        def add(*vs):
            conn.append([idx[v] for v in vs])

        for k in range(n - 1):
            for j in range(n - 1 - k):
                for i in range(n - 1 - k - j):
                    s = i + j + k
                    add((i, j, k), (i + 1, j, k), (i, j + 1, k),
                        (i, j, k + 1))
                    if s <= n - 3:
                        add((i + 1, j, k), (i, j + 1, k), (i, j, k + 1),
                            (i + 1, j, k + 1))
                        add((i + 1, j, k), (i + 1, j + 1, k), (i, j + 1, k),
                            (i + 1, j, k + 1))
                        add((i, j + 1, k), (i, j + 1, k + 1), (i, j, k + 1),
                            (i + 1, j, k + 1))
                        add((i, j + 1, k), (i + 1, j + 1, k),
                            (i + 1, j, k + 1), (i, j + 1, k + 1))
                    if s <= n - 4:
                        add((i + 1, j + 1, k), (i, j + 1, k + 1),
                            (i + 1, j, k + 1), (i + 1, j + 1, k + 1))
        return np.array(pts), np.array(conn), VTK_TETRA
    if ele_type == PRISM:
        tri_pts, tri_conn, _ = _plot_points(TRI, p_res)
        zs = np.linspace(-1.0, 1.0, p_res)
        npt = tri_pts.shape[0]
        pts = np.concatenate([
            np.column_stack([tri_pts, np.full(npt, z)]) for z in zs])
        conn = []
        for k in range(p_res - 1):
            lo, hi = k * npt, (k + 1) * npt
            for tri in tri_conn:
                conn.append([lo + v for v in tri] + [hi + v for v in tri])
        return pts, np.array(conn), VTK_WEDGE
    raise NotImplementedError(f"vtu plot points for ctype {ele_type}")


def diagnostic_fields(solver, u_ppts, grad_ppts, fields):
    """Named diagnostic fields at plot points
    (ref:src/eles.cpp:3885-3983)."""
    if not fields:
        return {}
    p = solver.p
    nd = solver.n_dims
    rho = u_ppts[..., 0]
    vel = u_ppts[..., 1:1 + nd] / rho[..., None]
    E = u_ppts[..., nd + 1]
    pres = (p.gamma - 1.0) * (E - 0.5 * rho * np.sum(vel**2, axis=-1))
    out = {}
    for name in fields:
        if name == "u":
            out[name] = vel[..., 0]
        elif name == "v":
            out[name] = vel[..., 1]
        elif name == "w":
            out[name] = vel[..., 2] if nd == 3 else np.zeros_like(rho)
        elif name == "energy":
            out[name] = E
        elif name == "pressure":
            out[name] = pres
        elif name == "mach":
            # clamp to a small positive floor so a non-physical state never
            # writes silent NaNs into plot files (the reference aborts on
            # NaN residuals instead, ref:src/output.cpp:2243-2245)
            c = np.sqrt(np.maximum(p.gamma * pres / np.maximum(rho, 1e-300),
                                   1e-300))
            out[name] = np.sqrt(np.sum(vel**2, axis=-1)) / c
        elif name in ("vorticity", "q_criterion", "scaled_q_criterion"):
            dvel = (grad_ppts[..., 1:1 + nd, :]
                    - vel[..., :, None] * grad_ppts[..., 0, None, :]) \
                / rho[..., None, None]
            if name == "vorticity":
                if nd == 2:
                    out[name] = dvel[..., 1, 0] - dvel[..., 0, 1]
                else:
                    wx = dvel[..., 2, 1] - dvel[..., 1, 2]
                    wy = dvel[..., 0, 2] - dvel[..., 2, 0]
                    wz = dvel[..., 1, 0] - dvel[..., 0, 1]
                    out[name] = np.sqrt(wx**2 + wy**2 + wz**2)
            else:
                S = 0.5 * (dvel + np.swapaxes(dvel, -1, -2))
                W = 0.5 * (dvel - np.swapaxes(dvel, -1, -2))
                SS = np.sum(S**2, axis=(-2, -1))
                q = 0.5 * (np.sum(W**2, axis=(-2, -1)) - SS)
                if name == "q_criterion":
                    out[name] = q
                else:
                    # normalized Q (ref:src/eles.cpp:3972-3978)
                    out[name] = q / (SS + 1e-24)
        elif name == "sensor" and solver.sensor_fn is not None:
            s = np.asarray(solver.sensor_fn(solver.u))
            out[name] = np.broadcast_to(s[:, None], rho.shape)
        else:
            raise ValueError(f"unknown diagnostic field '{name}'")
    return out


class _MixedBlockView:
    """A single-type view of a MixedSolver for the per-type writers."""

    def __init__(self, mixed, ct, idx):
        self.p = mixed.p
        self.n_dims = mixed.n_dims
        self.block = mixed.blocks[ct]
        self.ops = self.block.ops
        self.u = mixed.u[idx]
        ua = getattr(mixed, "u_avg", None)
        self.u_avg = ua[idx] if ua is not None else None
        self.sensor_fn = None
        sel = mixed.mt.sels[ct]
        m = mixed.mesh
        self.mesh = type(m)(n_dims=m.n_dims, xv=m.xv,
                            c2v=m.c2v[sel], c2n_v=m.c2n_v[sel],
                            ctype=m.ctype[sel], bc_id=m.bc_id[sel],
                            bc_names=list(m.bc_names))


def write_vtu(solver, directory: str, step: int, rank: int = 0,
              n_ranks: int = 1) -> str:
    """Write one rank's .vtu (+ the .pvtu index when rank 0).

    MixedSolver input writes one piece per element type plus a .pvtu
    listing all of them (the reference likewise loops element types,
    ref:src/output.cpp:527-560)."""
    if hasattr(solver, "cts"):           # MixedSolver
        pieces = []
        for idx, ct in enumerate(solver.cts):
            view = _MixedBlockView(solver, ct, idx)
            pieces.append(write_vtu(view, directory, step,
                                    rank=rank * 8 + idx, n_ranks=0))
        name = solver.p.data_file_name
        pvtu = os.path.join(directory, f"{name}_{step:09d}.pvtu")
        _write_pvtu(pvtu, solver.p, solver.n_dims,
                    [os.path.relpath(f, directory) for f in pieces])
        return pvtu
    p = solver.p
    nd = solver.n_dims
    name = p.data_file_name
    dirname = os.path.join(directory, f"{name}_{step:09d}")
    os.makedirs(dirname, exist_ok=True)

    pts_ref, subconn, vtk_type = _plot_points(solver.ops.ele_type, p.p_res)
    opp_p = solver.ops.interp_to(pts_ref)            # (P, U)
    u = np.asarray(solver.u, dtype=np.float64)
    u_ppts = np.einsum("pu,euf->epf", opp_p, u)

    # physical positions of plot points via the shape mapping
    from ..mesh.shape import shape_basis
    from ..solver.elements import mesh_shape_points
    spts, n_spts = mesh_shape_points(solver.mesh)
    sb = shape_basis(solver.ops.ele_type, pts_ref, n_spts)
    pos = np.einsum("ps,esd->epd", sb, spts)         # (E, P, d)

    # per-element physical gradient (uncorrected; visualization only)
    need_grad = any(f in ("vorticity", "q_criterion", "scaled_q_criterion")
                    for f in p.diagnostic_fields)
    grad_ppts = None
    if need_grad:
        U = solver.ops.n_upts
        tgrad = np.einsum("kgu,euf->ekfg",
                          solver.ops.opp_2_cat.reshape(U, nd, U), u)
        grad = np.einsum("euml,eufm->eufl", solver.block.jginv_upts, tgrad) \
            / solver.block.detjac_upts[..., None, None]
        grad_ppts = np.einsum("pu,eufd->epfd", opp_p, grad)

    diag = diagnostic_fields(solver, u_ppts, grad_ppts, p.diagnostic_fields)

    E, P = u_ppts.shape[:2]
    n_cells_sub = subconn.shape[0]
    pts3 = np.zeros((E, P, 3))
    pts3[..., :nd] = pos

    fname = os.path.join(dirname, f"{name}_{step:09d}_p{rank:04d}.vtu")
    with open(fname, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{E * P}" '
                f'NumberOfCells="{E * n_cells_sub}">\n')
        f.write('<Points>\n<DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        pts3.reshape(-1, 3).tofile(f, sep=" ")
        f.write('\n</DataArray>\n</Points>\n<Cells>\n')
        conn_all = (subconn[None, :, :]
                    + (np.arange(E) * P)[:, None, None]).reshape(-1)
        f.write('<DataArray type="Int64" Name="connectivity" format="ascii">\n')
        conn_all.tofile(f, sep=" ")
        f.write('\n</DataArray>\n')
        nvpc = subconn.shape[1]
        offs = np.arange(1, E * n_cells_sub + 1) * nvpc
        f.write('<DataArray type="Int64" Name="offsets" format="ascii">\n')
        offs.tofile(f, sep=" ")
        f.write('\n</DataArray>\n')
        f.write('<DataArray type="UInt8" Name="types" format="ascii">\n')
        np.full(E * n_cells_sub, vtk_type, dtype=np.uint8).tofile(f, sep=" ")
        f.write('\n</DataArray>\n</Cells>\n<PointData>\n')
        f.write('<DataArray type="Float64" Name="rho" format="ascii">\n')
        u_ppts[..., 0].reshape(-1).tofile(f, sep=" ")
        f.write('\n</DataArray>\n')
        # time-averaged fields (ref:src/eles.cpp:5648-5664)
        if p.average_fields and getattr(solver, "u_avg", None) is not None:
            avg_ppts = np.einsum(
                "pu,euf->epf", opp_p,
                np.asarray(solver.u_avg, dtype=np.float64))
            for i, fieldname in enumerate(p.average_fields):
                f.write(f'<DataArray type="Float64" Name="{fieldname}" '
                        'format="ascii">\n')
                avg_ppts[..., i].reshape(-1).tofile(f, sep=" ")
                f.write('\n</DataArray>\n')
        for fieldname, vals in diag.items():
            f.write(f'<DataArray type="Float64" Name="{fieldname}" '
                    'format="ascii">\n')
            vals.reshape(-1).tofile(f, sep=" ")
            f.write('\n</DataArray>\n')
        f.write('</PointData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')

    if rank == 0 and n_ranks > 0:
        pvtu = os.path.join(directory, f"{name}_{step:09d}.pvtu")
        _write_pvtu(pvtu, p, nd,
                    [f"{name}_{step:09d}/{name}_{step:09d}_p{r:04d}.vtu"
                     for r in range(n_ranks)])
    return fname


def _write_pvtu(path: str, p, nd: int, piece_names: list) -> None:
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PUnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<PUnstructuredGrid '
                'GhostLevel="0">\n')
        f.write('<PPoints><PDataArray type="Float64" '
                'NumberOfComponents="3"/></PPoints>\n<PPointData>\n')
        f.write('<PDataArray type="Float64" Name="rho"/>\n')
        for fieldname in p.average_fields:
            f.write(f'<PDataArray type="Float64" Name="{fieldname}"/>\n')
        for fieldname in p.diagnostic_fields:
            f.write(f'<PDataArray type="Float64" Name="{fieldname}"/>\n')
        f.write('</PPointData>\n')
        for src in piece_names:
            f.write(f'<Piece Source="{src}"/>\n')
        f.write('</PUnstructuredGrid>\n</VTKFile>\n')
