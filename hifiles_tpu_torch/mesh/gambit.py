"""Gambit neutral-file (.neu) mesh reader.

Format handling mirrors the reference (ref:src/mesh_reader.cpp:105-393):
6-line header, counts line, ELEMENTS/CELLS section (Gambit vertex order
remapped to tensor ordering for quads/hexes), NODAL COORDINATES, and
BOUNDARY CONDITIONS sections whose group names become the ``bc_<name>_*``
namespaces in the input deck.

Gambit element type codes: 1 edge, 2 quad, 3 tri, 4 brick, 5 wedge, 6 tet,
7 pyramid.  Gambit boundary-face numbering is remapped to the local face
order (ref:src/mesh_reader.cpp:332-375).

Copied from hifiles_tpu/mesh/gambit.py (lines 1-177) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import numpy as np

from .. import HEX, PRISM, QUAD, TET, TRI
from .core import MAX_F_PER_C, MAX_V_PER_C, MeshData

_GAMBIT_CTYPE = {3: TRI, 2: QUAD, 6: TET, 5: PRISM, 4: HEX}

# Gambit file vertex order -> our c2v slots (ref:src/mesh_reader.cpp:192-246)
_VERTEX_SLOTS = {
    (TRI, 3): [0, 1, 2],
    (TRI, 6): [0, 3, 1, 4, 2, 5],
    (QUAD, 4): [0, 1, 3, 2],
    (QUAD, 8): [0, 4, 1, 5, 2, 6, 3, 7],
    (TET, 4): [0, 1, 2, 3],
    (TET, 10): [0, 4, 1, 5, 7, 2, 6, 9, 8, 3],
    (PRISM, 6): [0, 1, 2, 3, 4, 5],
    (PRISM, 15): [0, 6, 1, 8, 7, 2, 9, 10, 11, 3, 12, 4, 14, 13, 5],
    (HEX, 8): [0, 2, 4, 6, 1, 3, 5, 7],
    (HEX, 20): [0, 11, 3, 12, 15, 4, 19, 7, 8, 10, 16, 18, 1, 9, 2, 13, 14,
                5, 17, 6],
}

# Gambit boundary-face number -> local face (ref:src/mesh_reader.cpp:332-375)
_FACE_REMAP = {
    2: lambda k: k - 1,     # quad
    3: lambda k: k - 1,     # tri
    4: lambda k: {1: 0, 2: 3, 3: 5, 4: 1, 5: 4, 6: 2}[k],   # hex
    6: lambda k: {1: 3, 2: 2, 3: 0, 4: 1}[k],               # tet
    5: lambda k: {1: 2, 2: 3, 3: 4, 4: 0, 5: 1}[k],         # prism
}


def read_gambit(path: str) -> MeshData:
    with open(path) as f:
        lines = f.read().splitlines()
    it = iter(range(len(lines)))

    # header: counts are on the line after "NUMNP" header block (6 lines in)
    counts_line = None
    for i, ln in enumerate(lines):
        if "NUMNP" in ln:
            counts_line = i + 1
            break
    if counts_line is None:
        counts_line = 6
    toks = lines[counts_line].split()
    n_verts, n_cells, _, n_bdy, n_ele_dims, n_dims = map(int, toks[:6])

    # --- elements
    start = next(i for i, ln in enumerate(lines) if "ELEMENTS/CELLS" in ln) + 1
    c2v = -np.ones((n_cells, MAX_V_PER_C), dtype=np.int64)
    c2n_v = np.zeros(n_cells, dtype=np.int64)
    ctype = np.zeros(n_cells, dtype=np.int64)
    icg = np.zeros(n_cells, dtype=np.int64)

    li = start
    for c in range(n_cells):
        toks = lines[li].split()
        li += 1
        cell_id, ele_type, n_v = int(toks[0]), int(toks[1]), int(toks[2])
        verts = [int(t) for t in toks[3:]]
        while len(verts) < n_v:           # continuation lines (>7/14/21 verts)
            verts.extend(int(t) for t in lines[li].split())
            li += 1
        ct = _GAMBIT_CTYPE[ele_type]
        slots = _VERTEX_SLOTS[(ct, n_v)]
        for file_pos, slot in enumerate(slots):
            c2v[c, slot] = verts[file_pos] - 1
        c2n_v[c] = n_v
        ctype[c] = ct
        icg[c] = cell_id - 1

    # --- vertices
    start = next(i for i, ln in enumerate(lines)
                 if "NODAL COORDINATES" in ln) + 1
    xv = np.empty((n_verts, n_dims))
    for v in range(n_verts):
        toks = lines[start + v].split()
        xv[int(toks[0]) - 1] = [float(t) for t in toks[1:1 + n_dims]]

    # --- boundary groups
    bc_id = -np.ones((n_cells, MAX_F_PER_C), dtype=np.int64)
    bc_names: list[str] = []
    pos = 0
    for b in range(n_bdy):
        start = next(i for i in range(pos, len(lines))
                     if "BOUNDARY CONDITIONS" in lines[i]) + 1
        pos = start
        toks = lines[start].split()
        name = toks[0]
        bcnf = int(toks[2])
        bc_names.append(name)
        for k in range(bcnf):
            toks = lines[start + 1 + k].split()
            cell, ele_type, face = int(toks[0]) - 1, int(toks[1]), int(toks[2])
            bc_id[cell, _FACE_REMAP[ele_type](face)] = b
        pos = start + 1 + bcnf

    return MeshData(n_dims=n_dims, xv=xv, c2v=c2v, c2n_v=c2n_v, ctype=ctype,
                    bc_id=bc_id, bc_names=bc_names,
                    ic2icg=np.arange(n_cells, dtype=np.int64))


# file order per cell = inverse walk of _VERTEX_SLOTS (write our slot s at
# the file position whose slots[pos] == s)
def write_gambit(mesh, path: str, title: str = "hifiles_tpu") -> str:
    """Write a MeshData as a Gambit neutral file the reference binary can
    read (linear tri/quad/hex/tet/prism; used to hand generated meshes to the
    reference solver for parity runs).  Mirrors read_gambit / the
    reference's stream parser (ref:src/mesh_reader.cpp:105-393)."""
    import numpy as np

    from .. import HEX, PRISM, QUAD, TET, TRI
    gambit_type = {TRI: 3, QUAD: 2, HEX: 4, TET: 6, PRISM: 5}
    n_cells = mesh.c2v.shape[0]
    n_verts = mesh.xv.shape[0]
    n_bdy = len(mesh.bc_names or [])
    nd = mesh.n_dims
    lines = [
        "        CONTROL INFO 2.3.16",
        "** GAMBIT NEUTRAL FILE",
        title,
        "PROGRAM:                Gambit     VERSION:  2.3.16",
        " written by hifiles_tpu",
        "     NUMNP     NELEM     NGRPS    NBSETS     NDFCD     NDFVL",
        f"{n_verts:10d}{n_cells:10d}{1:10d}{n_bdy:10d}{nd:10d}{nd:10d}",
        "ENDOFSECTION",
        "   NODAL COORDINATES 2.3.16",
    ]
    for v in range(n_verts):
        coords = "".join(f" {c: .11e}" for c in mesh.xv[v])
        lines.append(f"{v + 1:10d}{coords}")
    lines.append("ENDOFSECTION")
    lines.append("      ELEMENTS/CELLS 2.3.16")
    for c in range(n_cells):
        ct = int(mesh.ctype[c])
        nv = int(mesh.c2n_v[c])
        slots = _VERTEX_SLOTS[(ct, nv)]
        verts = [int(mesh.c2v[c, slots[pos]]) + 1 for pos in range(nv)]
        vstr = "".join(f"{v:8d}" for v in verts)
        lines.append(f"{c + 1:8d} {gambit_type[ct]:2d} {nv:2d} {vstr}")
    lines.append("ENDOFSECTION")
    # boundary groups: invert _FACE_REMAP to the gambit face number
    inv_remap = {
        2: lambda lf: lf + 1,
        3: lambda lf: lf + 1,
        4: lambda lf: {0: 1, 3: 2, 5: 3, 1: 4, 4: 5, 2: 6}[lf],
        6: lambda lf: {3: 1, 2: 2, 0: 3, 1: 4}[lf],
        5: lambda lf: {2: 1, 3: 2, 4: 3, 0: 4, 1: 5}[lf],
    }
    for b, name in enumerate(mesh.bc_names or []):
        faces = np.argwhere(mesh.bc_id == b)
        lines.append(" BOUNDARY CONDITIONS 2.3.16")
        lines.append(f"{name:>32s}{1:8d}{faces.shape[0]:8d}{0:8d}{6:8d}")
        for cell, lf in faces:
            gt = gambit_type[int(mesh.ctype[cell])]
            lines.append(f"{int(cell) + 1:10d}{gt:5d}"
                         f"{inv_remap[gt](int(lf)):5d}")
        lines.append("ENDOFSECTION")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
