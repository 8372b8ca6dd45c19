"""Shape-function mappings: reference element -> physical space.

calc_pos / calc_d_pos analogs (ref:src/eles.cpp calc_pos via per-type
eval_nodal_s_basis, e.g. ref:src/eles_quads.cpp:1022-1113).  Vectorized over
both evaluation points and elements.

Shape-point layouts follow the reference's tensor ordering for quads/hexes
(Gambit corner order is remapped at read time, ref:src/mesh_reader.cpp:203-246)
and the direct Gambit order for simplices.

Copied from hifiles_tpu/mesh/shape.py (lines 1-438) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import numpy as np

from .. import HEX, PRISM, QUAD, TET, TRI
from ..ops.basis import dlagrange_matrix, lagrange_matrix


def _equi_1d(n: int) -> np.ndarray:
    """Equispaced shape nodes on [-1,1] (ref:src/eles_quads.cpp:172-180)."""
    return -1.0 + 2.0 * np.arange(n) / (n - 1)


def quad_shape_basis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    """(n_pts, n_spts) nodal shape basis for quads
    (ref:src/eles_quads.cpp:1022-1063)."""
    locs = np.atleast_2d(locs)
    n1 = int(round(np.sqrt(n_spts)))
    if n1 * n1 == n_spts:
        nodes = _equi_1d(n1)
        Lx = lagrange_matrix(locs[:, 0], nodes)
        Ly = lagrange_matrix(locs[:, 1], nodes)
        out = np.empty((locs.shape[0], n_spts))
        for j in range(n1):       # index = i + n1*j (x-fastest)
            for i in range(n1):
                out[:, i + n1 * j] = Lx[:, i] * Ly[:, j]
        return out
    if n_spts == 8:
        x, y = locs[:, 0], locs[:, 1]
        return np.stack([
            -0.25 * (1 - x) * (1 - y) * (1 + x + y),
            -0.25 * (1 + x) * (1 - y) * (1 - x + y),
            -0.25 * (1 + x) * (1 + y) * (1 - x - y),
            -0.25 * (1 - x) * (1 + y) * (1 + x - y),
            0.5 * (1 - x) * (1 + x) * (1 - y),
            0.5 * (1 + x) * (1 + y) * (1 - y),
            0.5 * (1 - x) * (1 + x) * (1 + y),
            0.5 * (1 - x) * (1 + y) * (1 - y)], axis=1)
    raise NotImplementedError(f"quad shape basis with {n_spts} points")


def quad_shape_dbasis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    """(n_pts, n_spts, 2) derivatives (ref:src/eles_quads.cpp:1067-1113)."""
    locs = np.atleast_2d(locs)
    n1 = int(round(np.sqrt(n_spts)))
    if n1 * n1 == n_spts:
        nodes = _equi_1d(n1)
        Lx = lagrange_matrix(locs[:, 0], nodes)
        Ly = lagrange_matrix(locs[:, 1], nodes)
        Dx = dlagrange_matrix(locs[:, 0], nodes)
        Dy = dlagrange_matrix(locs[:, 1], nodes)
        out = np.empty((locs.shape[0], n_spts, 2))
        for j in range(n1):
            for i in range(n1):
                out[:, i + n1 * j, 0] = Dx[:, i] * Ly[:, j]
                out[:, i + n1 * j, 1] = Lx[:, i] * Dy[:, j]
        return out
    if n_spts == 8:
        x, y = locs[:, 0], locs[:, 1]
        d = np.empty((locs.shape[0], 8, 2))
        d[:, 0, 0] = -0.25 * (-1 + y) * (2 * x + y)
        d[:, 1, 0] = 0.25 * (-1 + y) * (y - 2 * x)
        d[:, 2, 0] = 0.25 * (1 + y) * (2 * x + y)
        d[:, 3, 0] = -0.25 * (1 + y) * (y - 2 * x)
        d[:, 4, 0] = x * (-1 + y)
        d[:, 5, 0] = -0.5 * (1 + y) * (-1 + y)
        d[:, 6, 0] = -x * (1 + y)
        d[:, 7, 0] = 0.5 * (1 + y) * (-1 + y)
        d[:, 0, 1] = -0.25 * (-1 + x) * (x + 2 * y)
        d[:, 1, 1] = 0.25 * (1 + x) * (2 * y - x)
        d[:, 2, 1] = 0.25 * (1 + x) * (x + 2 * y)
        d[:, 3, 1] = -0.25 * (-1 + x) * (2 * y - x)
        d[:, 4, 1] = 0.5 * (1 + x) * (-1 + x)
        d[:, 5, 1] = -y * (1 + x)
        d[:, 6, 1] = -0.5 * (1 + x) * (-1 + x)
        d[:, 7, 1] = y * (-1 + x)
        return d
    raise NotImplementedError(f"quad shape dbasis with {n_spts} points")


# 20-node serendipity hex node layout (corners 0-7 CCW bottom then top,
# then the 12 edge midpoints; matches the reference's quadratic-hex
# ordering, ref:src/eles_hexas.cpp:1215-1260 — the 20-node remaps in
# gambit.py/gmsh.py and corner_vlist_face target this layout)
_HEX20_REF = np.array([
    (-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
    (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1),
    (0, -1, -1), (1, 0, -1), (0, 1, -1), (-1, 0, -1),
    (-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
    (0, -1, 1), (1, 0, 1), (0, 1, 1), (-1, 0, 1)], dtype=np.float64)


def hex_shape_basis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    """Tensor-product trilinear/tri-quadratic hex shape basis.

    Tensor index = i + n1*j + n1*n1*k (x-fastest), matching the c2v remap
    (ref:src/mesh_reader.cpp:240-243, ref:src/mesh.cpp:536-574).
    n_spts == 20 evaluates the standard serendipity basis: corner
    N = (1+x xi)(1+y yi)(1+z zi)(x xi + y yi + z zi - 2)/8, mid-edge
    (xi = 0) N = (1-x^2)(1+y yi)(1+z zi)/4
    (ref:src/eles_hexas.cpp:1215-1260)."""
    locs = np.atleast_2d(locs)
    n1 = int(round(n_spts ** (1.0 / 3.0)))
    if n1**3 == n_spts:
        nodes = _equi_1d(n1)
        L = [lagrange_matrix(locs[:, ax], nodes) for ax in range(3)]
        out = np.empty((locs.shape[0], n_spts))
        for k in range(n1):
            for j in range(n1):
                for i in range(n1):
                    out[:, i + n1 * j + n1 * n1 * k] = (
                        L[0][:, i] * L[1][:, j] * L[2][:, k])
        return out
    if n_spts == 20:
        x, y, z = locs[:, 0], locs[:, 1], locs[:, 2]
        out = np.empty((locs.shape[0], 20))
        for m, (xi, yi, zi) in enumerate(_HEX20_REF):
            if xi and yi and zi:                       # corner
                out[:, m] = (0.125 * (1 + x * xi) * (1 + y * yi)
                             * (1 + z * zi)
                             * (x * xi + y * yi + z * zi - 2.0))
            elif xi == 0:                              # x-edge midpoint
                out[:, m] = 0.25 * (1 - x * x) * (1 + y * yi) * (1 + z * zi)
            elif yi == 0:
                out[:, m] = 0.25 * (1 + x * xi) * (1 - y * y) * (1 + z * zi)
            else:
                out[:, m] = 0.25 * (1 + x * xi) * (1 + y * yi) * (1 - z * z)
        return out
    raise NotImplementedError(f"hex shape basis with {n_spts} points")


def hex_shape_dbasis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    locs = np.atleast_2d(locs)
    n1 = int(round(n_spts ** (1.0 / 3.0)))
    if n1**3 == n_spts:
        nodes = _equi_1d(n1)
        L = [lagrange_matrix(locs[:, ax], nodes) for ax in range(3)]
        D = [dlagrange_matrix(locs[:, ax], nodes) for ax in range(3)]
        out = np.empty((locs.shape[0], n_spts, 3))
        for k in range(n1):
            for j in range(n1):
                for i in range(n1):
                    m = i + n1 * j + n1 * n1 * k
                    out[:, m, 0] = D[0][:, i] * L[1][:, j] * L[2][:, k]
                    out[:, m, 1] = L[0][:, i] * D[1][:, j] * L[2][:, k]
                    out[:, m, 2] = L[0][:, i] * L[1][:, j] * D[2][:, k]
        return out
    if n_spts == 20:
        x, y, z = locs[:, 0], locs[:, 1], locs[:, 2]
        out = np.empty((locs.shape[0], 20, 3))
        for m, (xi, yi, zi) in enumerate(_HEX20_REF):
            if xi and yi and zi:
                out[:, m, 0] = (0.125 * xi * (1 + y * yi) * (1 + z * zi)
                                * (2 * x * xi + y * yi + z * zi - 1.0))
                out[:, m, 1] = (0.125 * yi * (1 + x * xi) * (1 + z * zi)
                                * (x * xi + 2 * y * yi + z * zi - 1.0))
                out[:, m, 2] = (0.125 * zi * (1 + x * xi) * (1 + y * yi)
                                * (x * xi + y * yi + 2 * z * zi - 1.0))
            elif xi == 0:
                out[:, m, 0] = -0.5 * x * (1 + y * yi) * (1 + z * zi)
                out[:, m, 1] = 0.25 * yi * (1 - x * x) * (1 + z * zi)
                out[:, m, 2] = 0.25 * zi * (1 - x * x) * (1 + y * yi)
            elif yi == 0:
                out[:, m, 0] = 0.25 * xi * (1 - y * y) * (1 + z * zi)
                out[:, m, 1] = -0.5 * y * (1 + x * xi) * (1 + z * zi)
                out[:, m, 2] = 0.25 * zi * (1 + x * xi) * (1 - y * y)
            else:
                out[:, m, 0] = 0.25 * xi * (1 + y * yi) * (1 - z * z)
                out[:, m, 1] = 0.25 * yi * (1 + x * xi) * (1 - z * z)
                out[:, m, 2] = -0.5 * z * (1 + x * xi) * (1 + y * yi)
        return out
    raise NotImplementedError(f"hex shape dbasis with {n_spts} points")


def tri_shape_basis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    """Linear/quadratic triangle shape basis on the reference tri with
    vertices (-1,-1), (1,-1), (-1,1) (ref:src/eles_tris.cpp nodal shape
    basis).  Barycentric: l0 = -(r+s)/2, l1 = (1+r)/2, l2 = (1+s)/2."""
    locs = np.atleast_2d(locs)
    r, s = locs[:, 0], locs[:, 1]
    l0 = -0.5 * (r + s)
    l1 = 0.5 * (1 + r)
    l2 = 0.5 * (1 + s)
    if n_spts == 3:
        return np.stack([l0, l1, l2], axis=1)
    if n_spts == 6:
        return np.stack([
            l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
            4 * l0 * l1, 4 * l1 * l2, 4 * l0 * l2], axis=1)
    raise NotImplementedError(f"tri shape basis with {n_spts} points")


def tri_shape_dbasis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    locs = np.atleast_2d(locs)
    r, s = locs[:, 0], locs[:, 1]
    l0 = -0.5 * (r + s)
    l1 = 0.5 * (1 + r)
    l2 = 0.5 * (1 + s)
    # dl0 = (-1/2, -1/2), dl1 = (1/2, 0), dl2 = (0, 1/2)
    z = np.zeros_like(r)
    h = 0.5 * np.ones_like(r)
    d = {0: (-h, -h), 1: (h, z), 2: (z, h)}
    if n_spts == 3:
        out = np.empty((locs.shape[0], 3, 2))
        for m in range(3):
            out[:, m, 0], out[:, m, 1] = d[m]
        return out
    if n_spts == 6:
        out = np.empty((locs.shape[0], 6, 2))
        for m, lm in enumerate((l0, l1, l2)):
            out[:, m, 0] = (4 * lm - 1) * d[m][0]
            out[:, m, 1] = (4 * lm - 1) * d[m][1]
        pairs = [(0, 1), (1, 2), (0, 2)]
        for e, (a, b) in enumerate(pairs):
            la = (l0, l1, l2)[a]
            lb = (l0, l1, l2)[b]
            out[:, 3 + e, 0] = 4 * (d[a][0] * lb + la * d[b][0])
            out[:, 3 + e, 1] = 4 * (d[a][1] * lb + la * d[b][1])
        return out
    raise NotImplementedError(f"tri shape dbasis with {n_spts} points")


def tet_shape_basis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    """Linear/quadratic tet shape basis on the reference tet with vertices
    (-1,-1,-1), (1,-1,-1), (-1,1,-1), (-1,-1,1).  Barycentric:
    l0 = -(1+r+s+t)/2, l1 = (1+r)/2, l2 = (1+s)/2, l3 = (1+t)/2.
    Quadratic node ordering matches the Gambit remap
    (ref:src/mesh_reader.cpp:219-223)."""
    locs = np.atleast_2d(locs)
    r, s, t = locs[:, 0], locs[:, 1], locs[:, 2]
    L = [-0.5 * (1.0 + r + s + t), 0.5 * (1.0 + r), 0.5 * (1.0 + s),
         0.5 * (1.0 + t)]
    if n_spts == 4:
        return np.stack(L, axis=1)
    if n_spts == 10:
        cols = [li * (2 * li - 1) for li in L]
        edges = [(0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3)]
        cols += [4 * L[a] * L[b] for a, b in edges]
        return np.stack(cols, axis=1)
    raise NotImplementedError(f"tet shape basis with {n_spts} points")


def tet_shape_dbasis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    locs = np.atleast_2d(locs)
    r, s, t = locs[:, 0], locs[:, 1], locs[:, 2]
    L = [-0.5 * (1.0 + r + s + t), 0.5 * (1.0 + r), 0.5 * (1.0 + s),
         0.5 * (1.0 + t)]
    h = 0.5 * np.ones_like(r)
    z = np.zeros_like(r)
    dL = [(-h, -h, -h), (h, z, z), (z, h, z), (z, z, h)]
    if n_spts == 4:
        out = np.empty((locs.shape[0], 4, 3))
        for m in range(4):
            for ax in range(3):
                out[:, m, ax] = dL[m][ax]
        return out
    if n_spts == 10:
        out = np.empty((locs.shape[0], 10, 3))
        for m in range(4):
            for ax in range(3):
                out[:, m, ax] = (4 * L[m] - 1) * dL[m][ax]
        edges = [(0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3)]
        for e, (a, b) in enumerate(edges):
            for ax in range(3):
                out[:, 4 + e, ax] = 4 * (dL[a][ax] * L[b] + L[a] * dL[b][ax])
        return out
    raise NotImplementedError(f"tet shape dbasis with {n_spts} points")


def prism_shape_basis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    """Linear prism: tri barycentric x linear in z (bottom tri nodes 0,1,2,
    top tri 3,4,5 per the Gambit order, ref:src/mesh_reader.cpp:230-233).

    The 15-node quadratic prism is the tri-quadratic x z-quadratic
    serendipity product (no mid-z nodes on tri edges, no face/volume
    nodes): corners/tri-edge nodes pair the quadratic tri basis with the
    end-point quadratic z Lagrange z(z -+ 1)/2; the vertical mid-edge
    nodes pair the LINEAR tri basis with 1 - z^2.  Ordering: bottom
    corners 0-2, top corners 3-5, bottom tri edges 6-8 (01,12,02),
    vertical edges 9-11, top tri edges 12-14
    (ref:src/eles_pris.cpp:1114-1147)."""
    locs = np.atleast_2d(locs)
    if n_spts == 6:
        tri = tri_shape_basis(locs[:, :2], 3)
        zm = 0.5 * (1.0 - locs[:, 2])
        zp = 0.5 * (1.0 + locs[:, 2])
        return np.concatenate([tri * zm[:, None], tri * zp[:, None]],
                              axis=1)
    if n_spts == 15:
        z = locs[:, 2]
        t6 = tri_shape_basis(locs[:, :2], 6)   # c0,c1,c2,e01,e12,e02
        t3 = tri_shape_basis(locs[:, :2], 3)
        zb = 0.5 * z * (z - 1.0)               # quadratic Lagrange @ z=-1
        zt = 0.5 * z * (z + 1.0)               # @ z=+1
        zm = 1.0 - z * z                       # @ z=0
        cols = ([t6[:, m] * zb for m in range(3)]
                + [t6[:, m] * zt for m in range(3)]
                + [t6[:, 3 + e] * zb for e in range(3)]
                + [t3[:, m] * zm for m in range(3)]
                + [t6[:, 3 + e] * zt for e in range(3)])
        return np.stack(cols, axis=1)
    raise NotImplementedError(f"prism shape basis with {n_spts} points")


def prism_shape_dbasis(locs: np.ndarray, n_spts: int) -> np.ndarray:
    locs = np.atleast_2d(locs)
    if n_spts == 6:
        tri = tri_shape_basis(locs[:, :2], 3)
        dtri = tri_shape_dbasis(locs[:, :2], 3)
        zm = 0.5 * (1.0 - locs[:, 2])
        zp = 0.5 * (1.0 + locs[:, 2])
        out = np.empty((locs.shape[0], 6, 3))
        for m in range(3):
            for ax in range(2):
                out[:, m, ax] = dtri[:, m, ax] * zm
                out[:, 3 + m, ax] = dtri[:, m, ax] * zp
            out[:, m, 2] = -0.5 * tri[:, m]
            out[:, 3 + m, 2] = 0.5 * tri[:, m]
        return out
    if n_spts == 15:
        z = locs[:, 2]
        t6 = tri_shape_basis(locs[:, :2], 6)
        d6 = tri_shape_dbasis(locs[:, :2], 6)
        t3 = tri_shape_basis(locs[:, :2], 3)
        d3 = tri_shape_dbasis(locs[:, :2], 3)
        zf = [0.5 * z * (z - 1.0), 0.5 * z * (z + 1.0), 1.0 - z * z]
        dzf = [z - 0.5, z + 0.5, -2.0 * z]
        # (tri basis column index, tri order, z factor index) per node
        layout = ([(m, 6, 0) for m in range(3)]
                  + [(m, 6, 1) for m in range(3)]
                  + [(3 + e, 6, 0) for e in range(3)]
                  + [(m, 3, 2) for m in range(3)]
                  + [(3 + e, 6, 1) for e in range(3)])
        out = np.empty((locs.shape[0], 15, 3))
        for n, (col, order, zi) in enumerate(layout):
            t, d = (t6, d6) if order == 6 else (t3, d3)
            out[:, n, 0] = d[:, col, 0] * zf[zi]
            out[:, n, 1] = d[:, col, 1] * zf[zi]
            out[:, n, 2] = t[:, col] * dzf[zi]
        return out
    raise NotImplementedError(f"prism shape dbasis with {n_spts} points")


def shape_ref_locs(ctype: int, n_spts: int) -> np.ndarray:
    """Reference coordinates of each shape node of a supported layout,
    in the layout's own ordering (the locations where the corresponding
    shape basis is the identity).  Used to upcast lower-node cells to a
    block's common layout exactly (the reference keeps n_spts per cell,
    ref:src/eles.cpp calc_pos; a common layout vectorizes the block)."""
    if ctype == QUAD:
        n1 = int(round(np.sqrt(n_spts)))
        if n1 * n1 == n_spts:
            nodes = _equi_1d(n1)
            return np.array([(nodes[i], nodes[j])
                             for j in range(n1) for i in range(n1)])
        if n_spts == 8:
            return np.array([(-1, -1), (1, -1), (1, 1), (-1, 1),
                             (0, -1), (1, 0), (0, 1), (-1, 0)], float)
    if ctype == HEX:
        n1 = int(round(n_spts ** (1.0 / 3.0)))
        if n1 ** 3 == n_spts:
            nodes = _equi_1d(n1)
            return np.array([(nodes[i], nodes[j], nodes[k])
                             for k in range(n1) for j in range(n1)
                             for i in range(n1)])
        if n_spts == 20:
            return _HEX20_REF.copy()
    if ctype == TRI:
        v = np.array([(-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0)])
        if n_spts == 3:
            return v
        if n_spts == 6:
            pairs = [(0, 1), (1, 2), (0, 2)]
            return np.concatenate(
                [v, [(v[a] + v[b]) / 2 for a, b in pairs]], axis=0)
    if ctype == TET:
        v = np.array([(-1.0, -1.0, -1.0), (1.0, -1.0, -1.0),
                      (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0)])
        if n_spts == 4:
            return v
        if n_spts == 10:
            edges = [(0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3)]
            return np.concatenate(
                [v, [(v[a] + v[b]) / 2 for a, b in edges]], axis=0)
    if ctype == PRISM and n_spts == 6:
        t = np.array([(-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0)])
        return np.concatenate(
            [np.column_stack([t, -np.ones(3)]),
             np.column_stack([t, np.ones(3)])], axis=0)
    if ctype == PRISM and n_spts == 15:
        t = np.array([(-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0)])
        e = np.array([(t[a] + t[b]) / 2 for a, b in
                      ((0, 1), (1, 2), (0, 2))])
        col = np.column_stack
        return np.concatenate(
            [col([t, -np.ones(3)]), col([t, np.ones(3)]),
             col([e, -np.ones(3)]), col([t, np.zeros(3)]),
             col([e, np.ones(3)])], axis=0)
    raise NotImplementedError(f"shape ref locs ctype={ctype} n_spts={n_spts}")


def shape_basis(ctype: int, locs: np.ndarray, n_spts: int) -> np.ndarray:
    if ctype == QUAD:
        return quad_shape_basis(locs, n_spts)
    if ctype == HEX:
        return hex_shape_basis(locs, n_spts)
    if ctype == TRI:
        return tri_shape_basis(locs, n_spts)
    if ctype == TET:
        return tet_shape_basis(locs, n_spts)
    if ctype == PRISM:
        return prism_shape_basis(locs, n_spts)
    raise NotImplementedError(f"shape basis for ctype {ctype}")


def shape_dbasis(ctype: int, locs: np.ndarray, n_spts: int) -> np.ndarray:
    if ctype == QUAD:
        return quad_shape_dbasis(locs, n_spts)
    if ctype == HEX:
        return hex_shape_dbasis(locs, n_spts)
    if ctype == TRI:
        return tri_shape_dbasis(locs, n_spts)
    if ctype == TET:
        return tet_shape_dbasis(locs, n_spts)
    if ctype == PRISM:
        return prism_shape_dbasis(locs, n_spts)
    raise NotImplementedError(f"shape dbasis for ctype {ctype}")
