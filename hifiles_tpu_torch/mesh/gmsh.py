"""Gmsh 2.2 ASCII (.msh) reader (ref:src/mesh_reader.cpp:395-889).

Cells are the elements tagged with the "FLUID" physical group; other
physical groups are boundary groups whose lower-dimensional elements are
matched to cell faces by corner-vertex sets.  Gmsh vertex order is remapped
to the tensor c2v convention exactly as for Gambit.

Copied from hifiles_tpu/mesh/gmsh.py (lines 1-131) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import numpy as np

from .. import HEX, PRISM, QUAD, TET, TRI
from .core import MAX_F_PER_C, MAX_V_PER_C, NUM_F_PER_C, MeshData, \
    corner_vlist_face

# gmsh elm-type -> (ctype, n_v, slot map gmsh_pos -> c2v slot)
_GMSH_TYPES = {
    2: (TRI, 3, [0, 1, 2]),
    9: (TRI, 6, [0, 1, 2, 3, 4, 5]),
    3: (QUAD, 4, [0, 1, 3, 2]),
    16: (QUAD, 8, [0, 1, 2, 3, 4, 5, 6, 7]),
    4: (TET, 4, [0, 1, 2, 3]),
    11: (TET, 10, [0, 1, 2, 3, 4, 7, 5, 6, 8, 9]),
    6: (PRISM, 6, [0, 1, 2, 3, 4, 5]),
    18: (PRISM, 15, [0, 1, 2, 3, 4, 5, 6, 8, 9, 7, 10, 11, 12, 14, 13]),
    5: (HEX, 8, [0, 1, 3, 2, 4, 5, 7, 6]),
    # 20-node serendipity hex: corners coincide; gmsh edge order
    # {0,1},{0,3},{0,4},{1,2},{1,5},{2,3},{2,6},{3,7},{4,5},{4,7},{5,6},
    # {6,7} -> the reference's bottom-ring/verticals/top-ring layout
    # (mesh/shape.py _HEX20_REF, ref:src/eles_hexas.cpp:1215-1260)
    17: (HEX, 20, [0, 1, 2, 3, 4, 5, 6, 7,
                   8, 11, 12, 9, 13, 10, 14, 15, 16, 19, 17, 18]),
}
# boundary (face) element types: 1 line, 8 quadratic line, 2/9 tri, 3/16 quad
_FACE_TYPES = {1: 2, 8: 3, 2: 3, 9: 6, 3: 4, 16: 8}


def read_gmsh(path: str) -> MeshData:
    with open(path) as f:
        lines = f.read().splitlines()

    def section(name):
        for i, ln in enumerate(lines):
            if ln.strip() == f"${name}":
                return i + 1
        raise ValueError(f"${name} section not found in {path}")

    # physical names: find FLUID id; others are boundary groups
    i = section("PhysicalNames")
    n_names = int(lines[i])
    fluid_id = None
    bc_groups = {}       # gmsh physical id -> (name, our group index)
    mesh_dim = 2
    for k in range(n_names):
        toks = lines[i + 1 + k].split()
        dim, pid = int(toks[0]), int(toks[1])
        name = " ".join(toks[2:]).strip().strip('"')
        if name == "FLUID":
            fluid_id = pid
            mesh_dim = dim
        else:
            bc_groups[pid] = name
    if fluid_id is None:
        raise ValueError("no FLUID physical group in mesh")
    bc_names = list(bc_groups.values())
    bc_index = {pid: bc_names.index(nm) for pid, nm in bc_groups.items()}

    # nodes
    i = section("Nodes")
    n_nodes = int(lines[i])
    xv = np.empty((n_nodes, mesh_dim))
    for k in range(n_nodes):
        toks = lines[i + 1 + k].split()
        xv[int(toks[0]) - 1] = [float(t) for t in toks[1:1 + mesh_dim]]

    # elements
    i = section("Elements")
    n_ent = int(lines[i])
    cells = []
    bdy_faces = []       # (group index, corner vertex set)
    for k in range(n_ent):
        toks = [int(t) for t in lines[i + 1 + k].split()]
        elmtype, ntags = toks[1], toks[2]
        ptag = toks[3]
        verts = toks[3 + ntags:]
        if ptag == fluid_id:
            if elmtype not in _GMSH_TYPES:
                raise NotImplementedError(f"gmsh element type {elmtype}")
            ct, n_v, slots = _GMSH_TYPES[elmtype]
            c2v_row = -np.ones(MAX_V_PER_C, dtype=np.int64)
            for pos, slot in enumerate(slots):
                c2v_row[slot] = verts[pos] - 1
            cells.append((ct, n_v, c2v_row))
        elif ptag in bc_index:
            bdy_faces.append((bc_index[ptag],
                              frozenset(v - 1 for v in verts[:4])))

    C = len(cells)
    c2v = np.stack([c[2] for c in cells])
    c2n_v = np.array([c[1] for c in cells], dtype=np.int64)
    ctype = np.array([c[0] for c in cells], dtype=np.int64)

    # match boundary entities to cell faces by corner vertex sets
    bc_id = -np.ones((C, MAX_F_PER_C), dtype=np.int64)
    face_map = {}
    for c in range(C):
        for k in range(NUM_F_PER_C[int(ctype[c])]):
            vl = corner_vlist_face(int(ctype[c]), int(c2n_v[c]), k)
            key = frozenset(int(c2v[c, s]) for s in vl)
            face_map.setdefault(key, []).append((c, k))
    for (g, key) in bdy_faces:
        # boundary entity vertex set may include midside nodes; reduce to
        # the corner subset by matching any face whose corners are contained
        hit = face_map.get(key)
        if hit is None:
            # quadratic boundary entities: corners are the first 2 (line)
            # or 3 (tri) vertices
            hit = None
            for key2, v in face_map.items():
                if key2 <= key:
                    hit = v
                    break
        if hit is None:
            raise ValueError(f"boundary entity {key} matches no cell face")
        for (c, k) in hit:
            bc_id[c, k] = g

    return MeshData(n_dims=mesh_dim, xv=xv, c2v=c2v, c2n_v=c2n_v,
                    ctype=ctype, bc_id=bc_id, bc_names=bc_names,
                    ic2icg=np.arange(C, dtype=np.int64))
