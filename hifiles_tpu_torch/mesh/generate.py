"""Built-in structured mesh generators (periodic boxes for verification).

These produce MeshData with a single "Cyclic" boundary group so the same
cyclic-pairing code path as mesh-file runs (ref:src/geometry.cpp:351-415) is
exercised.

Copied from hifiles_tpu/mesh/generate.py (lines 1-557) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import numpy as np

from .. import HEX, QUAD, TET
from .core import MAX_F_PER_C, MAX_V_PER_C, MeshData


def periodic_quad_mesh(nx: int, ny: int, x0: float = -1.0, x1: float = 1.0,
                       y0: float = -1.0, y1: float = 1.0) -> MeshData:
    """Uniform nx x ny quad mesh on [x0,x1] x [y0,y1], all boundaries cyclic.

    c2v uses the reference's tensor ordering for linear quads:
    slots (0,1,2,3) = (bl, br, tl, tr) (ref:src/mesh_reader.cpp:205-206).
    """
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    xv = np.stack([X.ravel(), Y.ravel()], axis=-1)

    def vid(i, j):
        return j * (nx + 1) + i

    C = nx * ny
    c2v = -np.ones((C, MAX_V_PER_C), dtype=np.int64)
    bc_id = -np.ones((C, MAX_F_PER_C), dtype=np.int64)
    for j in range(ny):
        for i in range(nx):
            c = j * nx + i
            c2v[c, 0] = vid(i, j)
            c2v[c, 1] = vid(i + 1, j)
            c2v[c, 2] = vid(i, j + 1)
            c2v[c, 3] = vid(i + 1, j + 1)
            if j == 0:
                bc_id[c, 0] = 0
            if i == nx - 1:
                bc_id[c, 1] = 0
            if j == ny - 1:
                bc_id[c, 2] = 0
            if i == 0:
                bc_id[c, 3] = 0
    return MeshData(n_dims=2, xv=xv, c2v=c2v,
                    c2n_v=np.full(C, 4, dtype=np.int64),
                    ctype=np.full(C, QUAD, dtype=np.int64),
                    bc_id=bc_id, bc_names=["Cyclic"],
                    ic2icg=np.arange(C, dtype=np.int64))


def channel_quad_mesh(nx: int, ny: int, x0: float, x1: float,
                      y0: float, y1: float,
                      bc_x: str = "Inflow", bc_X: str = "Outflow",
                      bc_y: str | None = None) -> MeshData:
    """Quad channel: named BC groups on x- (bc_x) and x+ (bc_X) boundaries;
    y boundaries cyclic by default or a named group ``bc_y``."""
    mesh = periodic_quad_mesh(nx, ny, x0, x1, y0, y1)
    names = [bc_x, bc_X, bc_y if bc_y is not None else "Cyclic"]
    bc_id = -np.ones_like(mesh.bc_id)
    for j in range(ny):
        for i in range(nx):
            c = j * nx + i
            if j == 0:
                bc_id[c, 0] = 2
            if i == nx - 1:
                bc_id[c, 1] = 1
            if j == ny - 1:
                bc_id[c, 2] = 2
            if i == 0:
                bc_id[c, 3] = 0
    mesh.bc_id = bc_id
    mesh.bc_names = names
    return mesh


def ywall_channel_quad_mesh(nx: int, ny: int, x0: float, x1: float,
                            y0: float, y1: float,
                            bc_ymin: str = "Wall_Bot",
                            bc_ymax: str = "Wall_Top") -> MeshData:
    """x-cyclic quad channel with separately named wall groups on y- and
    y+ (Couette flow, ref:src/eles.cpp:5222-5245 test_case 5)."""
    mesh = periodic_quad_mesh(nx, ny, x0, x1, y0, y1)
    names = [bc_ymin, bc_ymax, "Cyclic"]
    bc_id = -np.ones_like(mesh.bc_id)
    for j in range(ny):
        for i in range(nx):
            c = j * nx + i
            if j == 0:
                bc_id[c, 0] = 0
            if i == nx - 1:
                bc_id[c, 1] = 2
            if j == ny - 1:
                bc_id[c, 2] = 1
            if i == 0:
                bc_id[c, 3] = 2
    mesh.bc_id = bc_id
    mesh.bc_names = names
    return mesh


def periodic_mixed_mesh_2d(nx: int, ny: int,
                           x0: float = -1.0, x1: float = 1.0,
                           y0: float = -1.0, y1: float = 1.0) -> MeshData:
    """Mixed tri+quad periodic box: the left half stays quads, each quad in
    the right half splits into 2 tris along the bl->tr diagonal.  The split
    pattern is constant in y so cyclic y faces match, and the x-cyclic pair
    is a quad edge against a tri edge (exercising the cross-type face path,
    ref:src/geometry.cpp:250-420 mixed inters wiring)."""
    from .. import TRI
    quadm = periodic_quad_mesh(nx, ny, x0, x1, y0, y1)
    half = nx // 2
    cells = []          # (ctype, vlist)
    for j in range(ny):
        for i in range(nx):
            q = quadm.c2v[j * nx + i, :4]      # bl, br, tl, tr
            if i < half:
                cells.append((QUAD, [q[0], q[1], q[2], q[3]]))
            else:
                cells.append((TRI, [q[0], q[1], q[3]]))   # bl, br, tr
                cells.append((TRI, [q[0], q[3], q[2]]))   # bl, tr, tl
    C = len(cells)
    c2v = -np.ones((C, MAX_V_PER_C), dtype=np.int64)
    ctype = np.empty(C, dtype=np.int64)
    c2n_v = np.empty(C, dtype=np.int64)
    for c, (ct, vl) in enumerate(cells):
        ctype[c] = ct
        c2n_v[c] = len(vl)
        c2v[c, :len(vl)] = vl
    bc_id = -np.ones((C, MAX_F_PER_C), dtype=np.int64)
    mesh = MeshData(n_dims=2, xv=quadm.xv.copy(), c2v=c2v, c2n_v=c2n_v,
                    ctype=ctype, bc_id=bc_id, bc_names=["Cyclic"],
                    ic2icg=np.arange(C, dtype=np.int64))
    from .core import NUM_F_PER_C, corner_vlist_face
    lo = np.array([x0, y0])
    hi = np.array([x1, y1])
    tol = 1e-10
    for c in range(C):
        for k in range(NUM_F_PER_C[int(ctype[c])]):
            vl = corner_vlist_face(int(ctype[c]), int(c2n_v[c]), k)
            pts = mesh.xv[c2v[c, vl]]
            for ax in range(2):
                if (np.abs(pts[:, ax] - lo[ax]) < tol).all() or \
                   (np.abs(pts[:, ax] - hi[ax]) < tol).all():
                    bc_id[c, k] = 0
    return mesh


def periodic_hex_mesh(nx: int, ny: int, nz: int,
                      x0: float = -np.pi, x1: float = np.pi,
                      y0: float = -np.pi, y1: float = np.pi,
                      z0: float = -np.pi, z1: float = np.pi) -> MeshData:
    """Uniform hex mesh on a periodic box (TGV domain by default).

    c2v tensor ordering for linear hexes: slot = i + 2j + 4k
    (ref:src/mesh_reader.cpp:240-241 remap).
    """
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)

    def vid(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    V = (nx + 1) * (ny + 1) * (nz + 1)
    xv = np.empty((V, 3))
    for k in range(nz + 1):
        for j in range(ny + 1):
            for i in range(nx + 1):
                xv[vid(i, j, k)] = (xs[i], ys[j], zs[k])

    C = nx * ny * nz
    c2v = -np.ones((C, MAX_V_PER_C), dtype=np.int64)
    bc_id = -np.ones((C, MAX_F_PER_C), dtype=np.int64)
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                c = (k * ny + j) * nx + i
                c2v[c, 0] = vid(i, j, k)
                c2v[c, 1] = vid(i + 1, j, k)
                c2v[c, 2] = vid(i, j + 1, k)
                c2v[c, 3] = vid(i + 1, j + 1, k)
                c2v[c, 4] = vid(i, j, k + 1)
                c2v[c, 5] = vid(i + 1, j, k + 1)
                c2v[c, 6] = vid(i, j + 1, k + 1)
                c2v[c, 7] = vid(i + 1, j + 1, k + 1)
                # local face order (ref:src/mesh.cpp:752-793):
                # 0 bottom(z-), 1 front(y-), 2 right(x+), 3 back(y+),
                # 4 left(x-), 5 top(z+)
                if k == 0:
                    bc_id[c, 0] = 0
                if j == 0:
                    bc_id[c, 1] = 0
                if i == nx - 1:
                    bc_id[c, 2] = 0
                if j == ny - 1:
                    bc_id[c, 3] = 0
                if i == 0:
                    bc_id[c, 4] = 0
                if k == nz - 1:
                    bc_id[c, 5] = 0
    return MeshData(n_dims=3, xv=xv, c2v=c2v,
                    c2n_v=np.full(C, 8, dtype=np.int64),
                    ctype=np.full(C, HEX, dtype=np.int64),
                    bc_id=bc_id, bc_names=["Cyclic"],
                    ic2icg=np.arange(C, dtype=np.int64))


def periodic_tet_mesh(nx: int, ny: int, nz: int,
                      x0: float = -np.pi, x1: float = np.pi,
                      y0: float = -np.pi, y1: float = np.pi,
                      z0: float = -np.pi, z1: float = np.pi) -> MeshData:
    """Periodic tet box: each hex of the structured grid split into 6 tets
    (Kuhn subdivision, translation-invariant so cyclic faces match)."""
    hexm = periodic_hex_mesh(nx, ny, nz, x0, x1, y0, y1, z0, z1)
    # hex c2v tensor slots: 0..7 = (i,j,k) bits (x fastest)
    # Kuhn: sort of path permutations of (0..7); standard 6-tet split along
    # main diagonal v0 -> v7
    splits = [(0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
              (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7)]
    C = hexm.n_cells * 6
    c2v = -np.ones((C, MAX_V_PER_C), dtype=np.int64)
    for h in range(hexm.n_cells):
        for t, sp in enumerate(splits):
            c2v[6 * h + t, :4] = hexm.c2v[h, list(sp)]
    bc_id = -np.ones((C, MAX_F_PER_C), dtype=np.int64)
    mesh = MeshData(n_dims=3, xv=hexm.xv.copy(), c2v=c2v,
                    c2n_v=np.full(C, 4, dtype=np.int64),
                    ctype=np.full(C, TET, dtype=np.int64),
                    bc_id=bc_id, bc_names=["Cyclic"],
                    ic2icg=np.arange(C, dtype=np.int64))
    # tag boundary faces: any tet face whose 3 vertices lie on a box face
    from .core import NUM_F_PER_C, corner_vlist_face
    lo = np.array([x0, y0, z0])
    hi = np.array([x1, y1, z1])
    tol = 1e-10
    for c in range(C):
        for k in range(4):
            vl = corner_vlist_face(TET, 4, k)
            pts = mesh.xv[c2v[c, vl]]
            for ax in range(3):
                if (np.abs(pts[:, ax] - lo[ax]) < tol).all() or \
                   (np.abs(pts[:, ax] - hi[ax]) < tol).all():
                    bc_id[c, k] = 0
    return mesh


def periodic_prism_mesh(nx: int, ny: int, nz: int,
                        x0: float = -np.pi, x1: float = np.pi,
                        y0: float = -np.pi, y1: float = np.pi,
                        z0: float = -np.pi, z1: float = np.pi) -> MeshData:
    """Periodic prism box: each hex split into 2 z-extruded prisms along the
    same xy diagonal (translation-invariant, so cyclic faces match)."""
    from .. import PRISM
    hexm = periodic_hex_mesh(nx, ny, nz, x0, x1, y0, y1, z0, z1)
    # hex tensor slots: bottom quad (0,1,2,3)=(bl,br,tl,tr), top (4..7)
    # prisms: bottom tri (bl,br,tr)+(top counterparts), (bl,tr,tl)+(top)
    splits = [((0, 1, 3), (4, 5, 7)), ((0, 3, 2), (4, 7, 6))]
    C = hexm.n_cells * 2
    c2v = -np.ones((C, MAX_V_PER_C), dtype=np.int64)
    for h in range(hexm.n_cells):
        for t, (bot, top) in enumerate(splits):
            c2v[2 * h + t, :3] = hexm.c2v[h, list(bot)]
            c2v[2 * h + t, 3:6] = hexm.c2v[h, list(top)]
    bc_id = -np.ones((C, MAX_F_PER_C), dtype=np.int64)
    mesh = MeshData(n_dims=3, xv=hexm.xv.copy(), c2v=c2v,
                    c2n_v=np.full(C, 6, dtype=np.int64),
                    ctype=np.full(C, PRISM, dtype=np.int64),
                    bc_id=bc_id, bc_names=["Cyclic"],
                    ic2icg=np.arange(C, dtype=np.int64))
    from .core import NUM_F_PER_C, corner_vlist_face
    lo = np.array([x0, y0, z0])
    hi = np.array([x1, y1, z1])
    tol = 1e-10
    for c in range(C):
        for k in range(5):
            vl = corner_vlist_face(PRISM, 6, k)
            pts = mesh.xv[c2v[c, vl]]
            for ax in range(3):
                if (np.abs(pts[:, ax] - lo[ax]) < tol).all() or \
                   (np.abs(pts[:, ax] - hi[ax]) < tol).all():
                    bc_id[c, k] = 0
    return mesh


def channel_prism_tet_mesh(nx: int, nz: int, ny_prism: int, ny_tet: int,
                           x0: float = 0.0, x1: float = 2.0,
                           y0: float = 0.0, y1: float = 1.0,
                           z0: float = 0.0, z1: float = 1.0,
                           bc_wall: str = "Wall", bc_top: str = "Top",
                           y_stretch: float = 1.0) -> MeshData:
    """Wall-layer mixed mesh: prism layers (tri cross-section in xz,
    extruded in wall-normal y) near the y=y0 wall, tets above — the reduced
    twin of the SD7003 wall-modeled ILES configuration (BASELINE config #4,
    ref:testcases/navier-stokes/readme.txt:42-77), which uses exactly this
    prism-near-wall / tet-above topology.

    Conformity: every xz quad is split along the (i,k)->(i+1,k+1) diagonal;
    the tet region uses the Kuhn 6-tet hex subdivision whose y-bottom face
    diagonal is the same (translation-invariant, so x/z cyclic faces and
    the prism/tet interface all match).

    x and z are cyclic ("Cyclic" group 0); y=y0 tags ``bc_wall`` (group 1),
    y=y1 tags ``bc_top`` (group 2).  ``y_stretch`` > 1 geometrically
    refines the y grid toward the wall.
    """
    from .. import PRISM
    from .core import corner_vlist_face

    ny = ny_prism + ny_tet
    xs = np.linspace(x0, x1, nx + 1)
    zs = np.linspace(z0, z1, nz + 1)
    if y_stretch == 1.0:
        ys = np.linspace(y0, y1, ny + 1)
    else:
        w = y_stretch ** np.arange(ny)
        ys = y0 + (y1 - y0) * np.concatenate([[0.0], np.cumsum(w)]) / w.sum()

    def vid(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    V = (nx + 1) * (ny + 1) * (nz + 1)
    xv = np.empty((V, 3))
    for k in range(nz + 1):
        for j in range(ny + 1):
            for i in range(nx + 1):
                xv[vid(i, j, k)] = (xs[i], ys[j], zs[k])

    # xz triangulation (diagonal A-D), both tris counterclockwise seen
    # from +y so the prism bottom-tri normal points at the top tri
    tris = []                  # (nx*nz*2, 3) of (i, k) pairs
    for k in range(nz):
        for i in range(nx):
            A, B = (i, k), (i + 1, k)
            C, D = (i, k + 1), (i + 1, k + 1)
            tris.append((A, D, B))
            tris.append((A, C, D))

    cells = []                 # (ctype, [verts])
    for j in range(ny_prism):
        for t in tris:
            bot = [vid(i, j, k) for (i, k) in t]
            top = [vid(i, j + 1, k) for (i, k) in t]
            cells.append((PRISM, bot + top))
    # Kuhn 6-tet split of each virtual hex (slot = di + 2*dj + 4*dk)
    kuhn = [(0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
            (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7)]
    for j in range(ny_prism, ny):
        for k in range(nz):
            for i in range(nx):
                hv = [vid(i + di, j + dj, k + dk)
                      for dk in (0, 1) for dj in (0, 1) for di in (0, 1)]
                # hv index = di + 2*dj + 4*dk
                for sp in kuhn:
                    cells.append((TET, [hv[s] for s in sp]))

    C = len(cells)
    c2v = -np.ones((C, MAX_V_PER_C), dtype=np.int64)
    c2n_v = np.empty(C, dtype=np.int64)
    ctype = np.empty(C, dtype=np.int64)
    for c, (ct, verts) in enumerate(cells):
        ctype[c] = ct
        c2n_v[c] = len(verts)
        c2v[c, :len(verts)] = verts

    # orientation sanity: positive volume for every tet
    tet_mask = ctype == TET
    if tet_mask.any():
        p0 = xv[c2v[tet_mask, 0]]
        e1 = xv[c2v[tet_mask, 1]] - p0
        e2 = xv[c2v[tet_mask, 2]] - p0
        e3 = xv[c2v[tet_mask, 3]] - p0
        vol = np.einsum("ij,ij->i", np.cross(e1, e2), e3)
        assert (vol > 0).all(), "negative tet orientation"

    bc_id = -np.ones((C, MAX_F_PER_C), dtype=np.int64)
    bc_names = ["Cyclic", bc_wall, bc_top]
    tol = 1e-12
    nf_of = {PRISM: 5, TET: 4}
    for c in range(C):
        ct = int(ctype[c])
        for f in range(nf_of[ct]):
            vl = corner_vlist_face(ct, int(c2n_v[c]), f)
            pts = xv[c2v[c, vl]]
            if (np.abs(pts[:, 1] - y0) < tol).all():
                bc_id[c, f] = 1
            elif (np.abs(pts[:, 1] - y1) < tol).all():
                bc_id[c, f] = 2
            elif ((np.abs(pts[:, 0] - x0) < tol).all()
                  or (np.abs(pts[:, 0] - x1) < tol).all()
                  or (np.abs(pts[:, 2] - z0) < tol).all()
                  or (np.abs(pts[:, 2] - z1) < tol).all()):
                bc_id[c, f] = 0
    return MeshData(n_dims=3, xv=xv, c2v=c2v, c2n_v=c2n_v, ctype=ctype,
                    bc_id=bc_id, bc_names=bc_names,
                    ic2icg=np.arange(C, dtype=np.int64))


def channel_hex_mesh(nx: int, ny: int, nz: int,
                     x0: float = 0.0, x1: float = 2 * np.pi,
                     y0: float = 0.0, y1: float = 2.0,
                     z0: float = 0.0, z1: float = np.pi,
                     bc_wall: str = "Wall",
                     y_stretch: float = 1.0) -> MeshData:
    """Hex channel: cyclic in x and z, no-slip walls at y=y0 and y=y1 —
    the plane-channel LES production topology (the reference's
    body-forced channel configuration, ref:src/eles.cpp:5281-5484
    evaluate_body_force; periodic-hill/channel cases in
    ref:testcases/navier-stokes/readme.txt).

    x/z boundary faces tag group 0 ("Cyclic"); both y faces tag
    ``bc_wall`` (group 1).  ``y_stretch`` > 1 geometrically refines the
    y spacing toward BOTH walls (symmetric two-sided stretch; ny must be
    even in that case)."""
    if y_stretch == 1.0:
        ys = np.linspace(y0, y1, ny + 1)
    else:
        assert ny % 2 == 0, "two-sided y_stretch needs even ny"
        w = y_stretch ** np.arange(ny // 2)    # spacing grows off the wall
        half = np.concatenate([[0.0], np.cumsum(w)]) / w.sum()
        ym = 0.5 * (y0 + y1)
        ys = np.concatenate([y0 + (ym - y0) * half,
                             (y1 - (y1 - ym) * half[::-1])[1:]])
    mesh = periodic_hex_mesh(nx, ny, nz, x0, x1, y0, y1, z0, z1)
    # remap y coordinates to the stretched grid (periodic_hex_mesh used
    # uniform spacing; vertex j index recovers from the uniform value)
    yu = np.linspace(y0, y1, ny + 1)
    j_of = np.rint((mesh.xv[:, 1] - y0) / (yu[1] - yu[0])).astype(int)
    mesh.xv[:, 1] = ys[j_of]
    # local hex face order (ref:src/mesh.cpp:752-793): 1 = y-, 3 = y+
    bc_id = mesh.bc_id
    C = mesh.n_cells
    for c in range(C):
        j = (c // nx) % ny
        if j == 0:
            bc_id[c, 1] = 1
        if j == ny - 1:
            bc_id[c, 3] = 1
    mesh.bc_names = ["Cyclic", bc_wall]
    return mesh


def channel_mixed_mesh_2d(nx: int, ny: int,
                          x0: float, x1: float, y0: float, y1: float,
                          bc_x: str = "Inflow",
                          bc_X: str = "Outflow") -> MeshData:
    """Mixed tri+quad channel: named groups on x- (``bc_x``, group 0) and
    x+ (``bc_X``, group 1); y boundaries cyclic (group 2) — the mixed
    twin of channel_quad_mesh for inflow/outflow test cases."""
    from .core import NUM_F_PER_C, corner_vlist_face
    mesh = periodic_mixed_mesh_2d(nx, ny, x0, x1, y0, y1)
    tol = 1e-12
    for c in range(mesh.n_cells):
        for k in range(NUM_F_PER_C[int(mesh.ctype[c])]):
            if mesh.bc_id[c, k] < 0:
                continue
            vl = corner_vlist_face(int(mesh.ctype[c]),
                                   int(mesh.c2n_v[c]), k)
            pts = mesh.xv[mesh.c2v[c, vl]]
            if (np.abs(pts[:, 0] - x0) < tol).all():
                mesh.bc_id[c, k] = 0
            elif (np.abs(pts[:, 0] - x1) < tol).all():
                mesh.bc_id[c, k] = 1
            else:
                mesh.bc_id[c, k] = 2
    mesh.bc_names = [bc_x, bc_X, "Cyclic"]
    return mesh


# 20-node serendipity hex connectivity (mesh/shape.py _HEX20_REF layout):
# edge endpoints in the quadratic layout's CCW corner numbering, and the
# tensor 8-node slot of each serendipity corner
_HEX20_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 5), (2, 6),
                (3, 7), (4, 5), (5, 6), (6, 7), (7, 4)]
_HEX20_CORNER_FROM_TENSOR = [0, 1, 3, 2, 4, 5, 7, 6]


def periodic_curved_hex20_mesh(nx: int, ny: int, nz: int,
                               amp: float = 0.08) -> MeshData:
    """Periodic box of quadratic 20-node serendipity hexes whose mid-edge
    nodes leave the chords — genuinely curved cells, the wall-resolved
    mesh class the reference reads from Gambit/Gmsh
    (ref:src/eles_hexas.cpp:1215-1292 quadratic shape basis,
    ref:src/mesh_reader.cpp:242-243 20-node remap).

    Built from periodic_hex_mesh by inserting one shared vertex per
    undirected edge, then displacing ALL nodes with a smooth
    box-periodic field (cyclic faces stay matched)."""
    mesh = periodic_hex_mesh(nx, ny, nz)
    C = mesh.n_cells
    xv = [x for x in mesh.xv]
    mid_of = {}
    c2v = -np.ones((C, MAX_V_PER_C), dtype=np.int64)
    for c in range(C):
        corners = [int(mesh.c2v[c, s]) for s in _HEX20_CORNER_FROM_TENSOR]
        c2v[c, :8] = corners
        for e, (a, b) in enumerate(_HEX20_EDGES):
            key = frozenset((corners[a], corners[b]))
            m = mid_of.get(key)
            if m is None:
                m = len(xv)
                xv.append(0.5 * (mesh.xv[corners[a]]
                                 + mesh.xv[corners[b]]))
                mid_of[key] = m
            c2v[c, 8 + e] = m
    mesh.xv = np.asarray(xv)
    mesh.c2v = c2v
    mesh.c2n_v = np.full(C, 20, dtype=np.int64)
    x = mesh.xv
    mesh.xv = x + amp * np.stack(
        [np.sin(x[:, 0]) * np.cos(x[:, 1]),
         np.sin(x[:, 1]) * np.cos(x[:, 2]),
         np.sin(x[:, 2]) * np.cos(x[:, 0])], axis=1)
    return mesh


# 15-node quadratic prism edges in the reference layout (mesh/shape.py):
# bottom tri 01,12,02 -> slots 6-8, verticals -> 9-11, top tri -> 12-14
_PRI15_EDGES = [(0, 1), (1, 2), (0, 2), (0, 3), (1, 4), (2, 5), (3, 4),
                (4, 5), (3, 5)]


def periodic_curved_prism15_mesh(nx: int, ny: int, nz: int,
                                 amp: float = 0.05) -> MeshData:
    """Periodic box of quadratic 15-node prisms with curved mid-edge
    nodes (ref:src/eles_pris.cpp:1114-1181 quadratic shape basis); same
    construction as periodic_curved_hex20_mesh."""
    mesh = periodic_prism_mesh(nx, ny, nz)
    C = mesh.n_cells
    xv = [x for x in mesh.xv]
    mid_of = {}
    c2v = -np.ones((C, MAX_V_PER_C), dtype=np.int64)
    for c in range(C):
        corners = [int(mesh.c2v[c, s]) for s in range(6)]
        c2v[c, :6] = corners
        for e, (a, b) in enumerate(_PRI15_EDGES):
            key = frozenset((corners[a], corners[b]))
            m = mid_of.get(key)
            if m is None:
                m = len(xv)
                xv.append(0.5 * (mesh.xv[corners[a]]
                                 + mesh.xv[corners[b]]))
                mid_of[key] = m
            c2v[c, 6 + e] = m
    mesh.xv = np.asarray(xv)
    mesh.c2v = c2v
    mesh.c2n_v = np.full(C, 15, dtype=np.int64)
    x = mesh.xv
    mesh.xv = x + amp * np.stack(
        [np.sin(x[:, 0]) * np.cos(x[:, 1]),
         np.sin(x[:, 1]) * np.cos(x[:, 2]),
         np.sin(x[:, 2]) * np.cos(x[:, 0])], axis=1)
    return mesh
