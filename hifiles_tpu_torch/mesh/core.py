"""Mesh container and face-connectivity construction.

Host-side (numpy) preprocessing that replaces the reference's
mesh/geometry layer (ref:src/mesh.cpp:375-485 set_face_connectivity,
ref:src/geometry.cpp:327-415 cyclic pairing).  The output is a set of flat
index tables the solver turns into gather/scatter maps — no pointer wiring.

Copied from hifiles_tpu/mesh/core.py (lines 1-275) unchanged but for this
paragraph and the two spans of ``build_faces`` (the program's tracing):
the port imports nothing of hifiles_tpu, and the relative imports now
resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import HEX, PRISM, QUAD, TET, TRI, tracing

MAX_V_PER_C = 27
MAX_F_PER_C = 6

NUM_F_PER_C = {TRI: 3, QUAD: 4, TET: 4, PRISM: 5, HEX: 6}


@dataclasses.dataclass
class MeshData:
    """Raw mesh: vertices, per-cell connectivity, boundary tags."""

    n_dims: int
    xv: np.ndarray          # (V, n_dims) vertex coordinates
    c2v: np.ndarray         # (C, MAX_V_PER_C) vertex ids, -1 padded
    c2n_v: np.ndarray       # (C,)
    ctype: np.ndarray       # (C,) CTYPE codes
    bc_id: np.ndarray       # (C, MAX_F_PER_C) boundary-group id or -1
    bc_names: list[str] = dataclasses.field(default_factory=list)
    ic2icg: np.ndarray | None = None   # local -> global cell index

    @property
    def n_cells(self) -> int:
        return self.c2v.shape[0]

    @property
    def n_verts(self) -> int:
        return self.xv.shape[0]


@dataclasses.dataclass
class FaceConnectivity:
    """Face lists produced by build_faces. All index arrays are numpy int64.

    Interior faces carry (left cell, left local face, right cell, right local
    face, rot_tag); boundary faces carry (cell, local face, bc group id).
    """

    # interior (including paired cyclic)
    int_ele_l: np.ndarray
    int_locf_l: np.ndarray
    int_ele_r: np.ndarray
    int_locf_r: np.ndarray
    int_rot: np.ndarray
    # boundary
    bdy_ele: np.ndarray
    bdy_locf: np.ndarray
    bdy_bcid: np.ndarray
    # per-face vertex count (for face-shape grouping with mixed elements)
    int_nv: np.ndarray
    bdy_nv: np.ndarray


def corner_vlist_face(ctype: int, n_spts: int, face: int) -> list[int]:
    """Local c2v slots of the corner vertices of ``face``
    (ref:src/mesh.cpp:585-851)."""
    if ctype == TRI:
        return [[0, 1], [1, 2], [2, 0]][face]
    if ctype == QUAD:
        n1 = int(round(np.sqrt(n_spts)))
        if n1 * n1 == n_spts:
            return [[0, n1 - 1], [n1 - 1, n_spts - 1],
                    [n_spts - 1, n_spts - n1], [n_spts - n1, 0]][face]
        if n_spts == 8:
            return [[0, 1], [1, 2], [2, 3], [3, 0]][face]
    if ctype == TET:
        return [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]][face]
    if ctype == PRISM:
        return [[0, 2, 1], [3, 4, 5], [0, 1, 4, 3], [1, 2, 5, 4],
                [2, 0, 3, 5]][face]
    if ctype == HEX:
        n1 = int(round(n_spts ** (1.0 / 3.0)))
        if n1**3 == n_spts:
            s = n1 * n1 * (n1 - 1)
            return [
                [n1 - 1, 0, n1 * (n1 - 1), n1 * n1 - 1],
                [0, n1 - 1, n1 - 1 + s, s],
                [n1 - 1, n1 * n1 - 1, n_spts - 1, n1 - 1 + s],
                [n1 * n1 - 1, n1 * (n1 - 1), n_spts - n1, n_spts - 1],
                [n1 * (n1 - 1), 0, s, n_spts - n1],
                [s, n1 - 1 + s, n_spts - 1, n_spts - n1],
            ][face]
        if n_spts == 20:
            return [[1, 0, 3, 2], [0, 1, 5, 4], [1, 2, 6, 5],
                    [2, 3, 7, 6], [3, 0, 4, 7], [4, 5, 6, 7]][face]
    raise NotImplementedError(f"corner_vlist_face ctype={ctype} n_spts={n_spts}")


def _compare_faces(v1: list[int], v2: list[int]) -> int | None:
    """Orientation tag of face 2 w.r.t. face 1, or None if no match
    (ref:src/mesh.cpp:853-952)."""
    n = len(v1)
    if n == 2:
        if (v1[0] == v2[0] and v1[1] == v2[1]) or \
           (v1[0] == v2[1] and v1[1] == v2[0]):
            return 0
        return None
    if n == 3:
        perms = {0: (0, 2, 1), 1: (2, 1, 0), 2: (1, 0, 2)}
    elif n == 4:
        perms = {0: (1, 0, 3, 2), 1: (3, 2, 1, 0), 2: (0, 3, 2, 1),
                 3: (2, 1, 0, 3)}
    else:
        raise ValueError(n)
    for rtag, perm in perms.items():
        if all(v1[i] == v2[perm[i]] for i in range(n)):
            return rtag
    return None


def _cyclic_rtag(x1: np.ndarray, x2: np.ndarray, delta: np.ndarray,
                 tol: float) -> int:
    """Orientation tag for a cyclic face pair, by matching vertex positions
    modulo the cyclic offset (ref:src/geometry.cpp:1341-1441)."""
    n = x1.shape[0]

    def same(a, b):
        d = np.abs(np.abs(a - b))
        # either coordinates agree, or they differ by one cyclic offset
        ok = np.zeros(len(a), dtype=bool)
        agree = d < tol
        offs = np.abs(d - delta[:len(a)]) < tol
        return np.all(agree | offs)

    if n == 2:
        return 0
    if n == 3:
        perms = {0: (0, 2, 1), 1: (2, 1, 0), 2: (1, 0, 2)}
    else:
        perms = {0: (1, 0, 3, 2), 1: (3, 2, 1, 0), 2: (0, 3, 2, 1),
                 3: (2, 1, 0, 3)}
    for rtag, perm in perms.items():
        if all(same(x1[i], x2[perm[i]]) for i in range(n)):
            return rtag
    raise ValueError("could not determine cyclic rotation tag")


def _face_candidates(mesh: MeshData):
    """All (cell, locface) candidate faces with padded corner-vertex rows,
    vectorized per (ctype, n_spts) group, in cell-major order."""
    cells, locfs, nvs, verts = [], [], [], []
    for ct in np.unique(mesh.ctype):
        for nsp in np.unique(mesh.c2n_v[mesh.ctype == ct]):
            s2 = np.where((mesh.ctype == ct) & (mesh.c2n_v == nsp))[0]
            for k in range(NUM_F_PER_C[int(ct)]):
                slots = corner_vlist_face(int(ct), int(nsp), k)
                vp = np.full((s2.size, 4), -1, dtype=np.int64)
                vp[:, :len(slots)] = mesh.c2v[s2][:, slots]
                cells.append(s2)
                locfs.append(np.full(s2.size, k, dtype=np.int64))
                nvs.append(np.full(s2.size, len(slots), dtype=np.int64))
                verts.append(vp)
    cells = np.concatenate(cells)
    locfs = np.concatenate(locfs)
    nvs = np.concatenate(nvs)
    verts = np.concatenate(verts)
    order = np.lexsort((locfs, cells))    # cell-major, matches the scan order
    return cells[order], locfs[order], nvs[order], verts[order]


def build_faces(mesh: MeshData, bc_flags: dict[int, int] | None = None,
                delta_cyclic: np.ndarray | None = None,
                tol: float = 1e-6) -> FaceConnectivity:
    """Construct interior/boundary face lists with rotation tags.

    ``bc_flags`` maps boundary-group id -> BCFLAG; groups flagged CYCLIC (7)
    are paired by centroid offset and become interior faces
    (ref:src/geometry.cpp:351-415).  The O(faces) interior hash-matching
    runs in the native C++ kernel when available
    (native/mesh_kernels.cc hf_build_faces).  The spans
    setup.faces.interior and setup.faces.cyclic time the two pairings.
    """
    from ..config.params import CYCLIC
    from .. import native

    with tracing.span("setup.faces.interior"):
        fc, fl, fn, fv = _face_candidates(mesh)
        int_faces = []
        leftovers = []    # (cell, locface, vlist)

        res = native.build_faces_native(fc, fl, fn, fv)
        if res is not None:
            int_rows, un = res
            int_faces = [tuple(r) for r in int_rows]
            leftovers = [(int(fc[r]), int(fl[r]),
                          [int(v) for v in fv[r][:fn[r]]]) for r in un]
        else:
            face_map: dict[tuple, tuple] = {}
            for r in range(fc.size):
                ic, k = int(fc[r]), int(fl[r])
                vlist = [int(v) for v in fv[r][:fn[r]]]
                key = tuple(sorted(vlist))
                if key in face_map:
                    ic0, k0, vlist0 = face_map.pop(key)
                    rtag = _compare_faces(vlist0, vlist)
                    if rtag is None:
                        raise ValueError(
                            f"faces share vertices but no orientation "
                            f"match: cells {ic0}/{ic}")
                    int_faces.append((ic0, k0, ic, k, rtag, len(vlist)))
                else:
                    face_map[key] = (ic, k, vlist)
            leftovers = list(face_map.values())

    with tracing.span("setup.faces.cyclic"):
        # remaining faces: boundary or cyclic
        bdy_faces = []
        cyc_candidates = []
        for (ic, k, vlist) in leftovers:
            bcid = int(mesh.bc_id[ic, k])
            if bcid < 0:
                raise ValueError(f"unmatched interior face: cell {ic} "
                                 f"locface {k} has no boundary tag")
            flag = bc_flags.get(bcid, -1) if bc_flags else -1
            if flag == CYCLIC:
                cyc_candidates.append((ic, k, vlist, bcid))
            else:
                bdy_faces.append((ic, k, bcid, len(vlist)))

        # cyclic pairing by face centroid offset
        # (ref:src/geometry.cpp:351-415)
        if cyc_candidates:
            if delta_cyclic is None:
                raise ValueError("cyclic boundaries present but no "
                                 "dx/dy/dz_cyclic offsets given")
            delta = np.asarray(delta_cyclic, dtype=np.float64)
            centers = np.array([mesh.xv[v].mean(axis=0)
                                for (_, _, v, _) in cyc_candidates])
            used = np.zeros(len(cyc_candidates), dtype=bool)
            for i in range(len(cyc_candidates)):
                if used[i]:
                    continue
                ic1, k1, v1, _ = cyc_candidates[i]
                found = False
                for j in range(i + 1, len(cyc_candidates)):
                    if used[j]:
                        continue
                    ic2, k2, v2, _ = cyc_candidates[j]
                    if len(v1) != len(v2):
                        continue
                    d = np.abs(centers[i] - centers[j])
                    # match when the offset is one cyclic period along one
                    # axis (and zero along the others), per check_cyclic
                    axis_match = np.isclose(d, delta[:len(d)], atol=tol)
                    zero_match = d < tol
                    if np.all(axis_match | zero_match) and np.any(axis_match):
                        x1 = mesh.xv[v1]
                        x2 = mesh.xv[v2]
                        rtag = _cyclic_rtag(x1, x2, delta, tol)
                        int_faces.append((ic1, k1, ic2, k2, rtag, len(v1)))
                        used[i] = used[j] = True
                        found = True
                        break
                if not found:
                    raise ValueError(f"cannot find cyclic partner for cell "
                                     f"{ic1} locface {k1}")

    int_faces_a = np.array(int_faces, dtype=np.int64).reshape(-1, 6)
    bdy_faces_a = np.array(bdy_faces, dtype=np.int64).reshape(-1, 4)
    return FaceConnectivity(
        int_ele_l=int_faces_a[:, 0], int_locf_l=int_faces_a[:, 1],
        int_ele_r=int_faces_a[:, 2], int_locf_r=int_faces_a[:, 3],
        int_rot=int_faces_a[:, 4], int_nv=int_faces_a[:, 5],
        bdy_ele=bdy_faces_a[:, 0], bdy_locf=bdy_faces_a[:, 1],
        bdy_bcid=bdy_faces_a[:, 2], bdy_nv=bdy_faces_a[:, 3])
