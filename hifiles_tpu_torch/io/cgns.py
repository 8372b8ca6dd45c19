"""CGNS output (ref:src/output.cpp:901-1401 write_CGNS).

Writes the CGNS/HDF5 file format directly with h5py — no libcgns needed.
Every CGNS node is an HDF5 group carrying the ADF-mapping attributes
('name'/'label' as 33-byte strings, 'type' as a 3-byte code) with its
payload in a dataset called ' data'; strings are C1 int8 arrays.  The node
tree written here (Base / Zone / GridCoordinates / Elements / FlowSolution,
vertex-located fields on the plot-point lattice) mirrors what the
reference emits through the CGNS mid-level library.

Like the reference (and write_vtu), the grid written is the PLOT lattice:
each element subdivided into p_res-1 linear sub-cells with the solution
interpolated to the plot points.

Copied from hifiles_tpu/io/cgns.py (lines 1-162) unchanged but for this
paragraph.  h5py is imported inside the functions that need it, as there.
"""

from __future__ import annotations

import os

import numpy as np

from .. import HEX, PRISM, QUAD, TET, TRI
from .vtu import _plot_points, diagnostic_fields

# CGNS ElementType_t codes (SIDS table 8.1)
_CGNS_ETYPE = {TRI: 5, QUAD: 7, TET: 10, PRISM: 14, HEX: 17}
# VTK and CGNS share node ordering for these linear cells


def _write_str_attr(obj, key: str, value: str, size: int):
    """Fixed-size null-padded string attribute (ADF mapping)."""
    import h5py
    sid = h5py.h5s.create(h5py.h5s.SCALAR)
    tid = h5py.h5t.C_S1.copy()
    tid.set_size(size)
    tid.set_strpad(h5py.h5t.STR_NULLTERM)
    aid = h5py.h5a.create(obj.id, key.encode(), tid, sid)
    buf = value.encode()[: size - 1].ljust(size, b"\0")
    aid.write(np.frombuffer(buf, dtype=f"S{size}"))


def _node(parent, name: str, label: str, dtype_code: str, data=None):
    """Create one CGNS node: group + name/label/type attrs + ' data'."""
    g = parent.create_group(name)
    _write_str_attr(g, "name", name, 33)
    _write_str_attr(g, "label", label, 33)
    _write_str_attr(g, "type", dtype_code, 3)
    if data is not None:
        if dtype_code == "C1":
            arr = np.frombuffer(str(data).encode(), dtype=np.int8)
        elif dtype_code == "I4":
            arr = np.asarray(data, dtype=np.int32)
        elif dtype_code == "R4":
            arr = np.asarray(data, dtype=np.float32)
        else:
            arr = np.asarray(data, dtype=np.float64)
        g.create_dataset(" data", data=arr)
    return g


def write_cgns(solver, directory: str, step: int) -> str:
    """Write <data_file_name>_<step>.cgns for a single- or mixed-type
    solver; returns the path."""
    import h5py

    p = solver.p
    name = p.data_file_name
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}_{step:09d}.cgns")

    views = []
    if hasattr(solver, "cts"):        # MixedSolver: one zone per type
        from .vtu import _MixedBlockView
        for idx, ct in enumerate(solver.cts):
            views.append(_MixedBlockView(solver, ct, idx))
    else:
        views.append(solver)

    nd = views[0].n_dims
    with h5py.File(path, "w") as f:
        root = f["/"]
        _write_str_attr(root, "name", "HDF5 MotherNode", 33)
        _write_str_attr(root, "label", "Root Node of HDF5 File", 33)
        _write_str_attr(root, "type", "MT", 3)
        root.create_dataset(" format", data=np.frombuffer(
            b"IEEE_LITTLE_32\0", dtype=np.int8))
        root.create_dataset(" hdf5version", data=np.frombuffer(
            h5py.version.hdf5_version.encode().ljust(33, b"\0"),
            dtype=np.int8))
        _node(root, "CGNSLibraryVersion", "CGNSLibraryVersion_t", "R4",
              [3.3])
        base = _node(root, "Base", "CGNSBase_t", "I4", [nd, nd])

        for zi, view in enumerate(views):
            pts_ref, subconn, _ = _plot_points(view.ops.ele_type, p.p_res)
            opp_p = view.ops.interp_to(pts_ref)
            u = np.asarray(view.u, dtype=np.float64)
            u_ppts = np.einsum("pu,euf->epf", opp_p, u)

            from ..mesh.shape import shape_basis
            from ..solver.elements import mesh_shape_points
            spts, n_spts = mesh_shape_points(view.mesh)
            sb = shape_basis(view.ops.ele_type, pts_ref, n_spts)
            pos = np.einsum("ps,esd->epd", sb, spts)      # (E, P, d)

            E, P = u_ppts.shape[:2]
            nv = E * P
            nc = E * subconn.shape[0]
            conn = (subconn[None, :, :]
                    + (np.arange(E) * P)[:, None, None]).reshape(-1) + 1

            zone = _node(base, f"Zone{zi + 1}", "Zone_t", "I4",
                         np.array([[nv, nc, 0]], dtype=np.int32))
            _node(zone, "ZoneType", "ZoneType_t", "C1", "Unstructured")
            gc = _node(zone, "GridCoordinates", "GridCoordinates_t", "MT")
            coords = pos.reshape(nv, nd)
            axes = ["CoordinateX", "CoordinateY", "CoordinateZ"]
            for k in range(3):
                vals = coords[:, k] if k < nd else np.zeros(nv)
                _node(gc, axes[k], "DataArray_t", "R8", vals)
            elems = _node(zone, "Elem", "Elements_t", "I4",
                          [_CGNS_ETYPE[view.ops.ele_type], 0])
            _node(elems, "ElementRange", "IndexRange_t", "I4", [1, nc])
            _node(elems, "ElementConnectivity", "DataArray_t", "I4", conn)

            sol = _node(zone, "FlowSolution", "FlowSolution_t", "MT")
            _node(sol, "GridLocation", "GridLocation_t", "C1", "Vertex")
            _node(sol, "Density", "DataArray_t", "R8",
                  u_ppts[..., 0].reshape(-1))
            diag = diagnostic_fields(view, u_ppts, None,
                                     [d for d in p.diagnostic_fields
                                      if d not in ("vorticity", "q_criterion",
                                                   "scaled_q_criterion",
                                                   "sensor")])
            cgns_name = {"u": "VelocityX", "v": "VelocityY",
                         "w": "VelocityZ", "pressure": "Pressure",
                         "mach": "Mach", "energy": "EnergyStagnationDensity"}
            for fieldname, vals in diag.items():
                _node(sol, cgns_name.get(fieldname, fieldname),
                      "DataArray_t", "R8", vals.reshape(-1))
    return path


def read_cgns_summary(path: str) -> dict:
    """Structural check used by tests and debugging: zone sizes + fields."""
    import h5py

    out = {"zones": []}
    with h5py.File(path, "r") as f:
        base = f["Base"]
        for zname in sorted(k for k in base if k.startswith("Zone")):
            z = base[zname]
            nv, nc, _ = np.asarray(z[" data"]).reshape(-1)[:3]
            fields = sorted(k for k in z["FlowSolution"]
                            if k != "GridLocation" and not k.startswith(" "))
            conn = np.asarray(z["Elem"]["ElementConnectivity"][" data"])
            out["zones"].append(dict(
                name=zname, n_vertices=int(nv), n_cells=int(nc),
                fields=fields, conn_min=int(conn.min()),
                conn_max=int(conn.max()),
                x=np.asarray(z["GridCoordinates"]["CoordinateX"][" data"])))
    return out
