"""Element blocks: batched geometry transforms + face gather tables.

Copied from hifiles_tpu/solver/elements.py (lines 27-636: the single-type
blocks, the mixed-mesh tables MixedMeshTables, mixed_type_selections and
build_mixed_blocks, and the corner helpers) with only the imports rewired
to the port's own copies of the host layers (mesh/, ops/, native/).

This replaces the reference's eles/inters pointer machinery
(ref:src/eles.cpp:4015-4393 set_transforms, ref:src/int_inters.cpp:67-121
pointer wiring) with precomputed index arrays:

  * every element flux point is a flat "slot" s = ele * Pf + fpt
  * interior faces store left/right slot ids, the right side rotated by the
    reference's lut (ref:src/inters.cpp:153-262)
  * a slot-level inverse map turns the per-face common fluxes back into the
    per-slot normal transformed flux with a single gather (no scatter)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
from scipy.spatial import cKDTree

from .. import HEX, PRISM, QUAD, TET, TRI
from ..mesh.core import FaceConnectivity, MeshData
from ..mesh.shape import shape_basis, shape_dbasis
from ..ops.operators import ElementOps
from ..ops.stabilization import build_over_int_ops


def _adjugate(J: np.ndarray) -> np.ndarray:
    """adj(J) with adj(J) @ J = det(J) I; matches the reference's JGinv
    (ref:src/eles.cpp:4103-4135)."""
    d = J.shape[-1]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        out = np.empty_like(J)
        out[..., 0, 0] = e
        out[..., 0, 1] = -b
        out[..., 1, 0] = -c
        out[..., 1, 1] = a
        return out
    if d == 3:
        out = np.empty_like(J)
        for i in range(3):
            for j in range(3):
                r = [k for k in range(3) if k != j]
                c = [k for k in range(3) if k != i]
                minor = (J[..., r[0], c[0]] * J[..., r[1], c[1]]
                         - J[..., r[0], c[1]] * J[..., r[1], c[0]])
                out[..., i, j] = (-1.0) ** (i + j) * minor
        return out
    raise ValueError(d)


def face_lut(face_nv: int, n_fpts: int, rot_tag: int, order: int) -> np.ndarray:
    """fpt permutation matching a rotated neighbor face
    (ref:src/inters.cpp:153-262)."""
    if face_nv == 2:  # segment (2-D edge)
        return np.arange(n_fpts)[::-1].copy()
    if face_nv == 4:  # quad face (3-D)
        n = order + 1
        i, j = np.divmod(np.arange(n_fpts), n)
        if rot_tag == 0:
            return (n - 1 - j) + n * i
        if rot_tag == 1:
            return n_fpts - ((n - 1 - j) + n * i) - 1
        if rot_tag == 2:
            return n * j + i
        if rot_tag == 3:
            return n_fpts - (n * j + i) - 1
    if face_nv == 3:  # tri face (3-D)
        n = order + 1
        lut = np.empty(n_fpts, dtype=np.int64)
        if rot_tag == 0:
            for j in range(n):
                for i in range(n - j):
                    i0 = j * n - (j - 1) * j // 2 + i
                    lut[i0] = i * n - (i - 1) * i // 2 + j
            return lut
        if rot_tag == 1:
            for j in range(n):
                for i in range(n - j):
                    i0 = j * n - (j - 1) * j // 2 + i
                    lut[i0] = n * (n + 1) // 2 - 1 - (i + j) * (i + j + 1) // 2 - j
            return lut
        if rot_tag == 2:
            for j in range(n):
                for i in range(n - j):
                    i0 = j * n - (j - 1) * j // 2 + i
                    lut[i0] = j * n - (j - 1) * j // 2 + (n - 1 - j - i)
            return lut
    raise ValueError(f"face_lut(face_nv={face_nv}, rot={rot_tag})")


def match_fpts(pos_l: np.ndarray, pos_r: np.ndarray,
               tol: float = 1e-7) -> np.ndarray:
    """Geometric flux-point matching across a shared face.

    Returns perm with pos_r[perm[j]] == pos_l[j], comparing centroid-relative
    positions so cyclic (translated) faces match too.  This replaces the
    reference's analytic rotation-tag luts (ref:src/inters.cpp:153-262),
    which silently break for point sets without the assumed lattice
    ordering; geometric matching is exact for any symmetric set."""
    a = pos_l - pos_l.mean(axis=0)
    b = pos_r - pos_r.mean(axis=0)
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    perm = d2.argmin(axis=1)
    scale = max(np.abs(a).max(), 1e-30)
    if (np.sort(perm).tolist() != list(range(len(perm)))
            or np.sqrt(d2[np.arange(len(perm)), perm]).max() > tol * max(
                1.0, scale)):
        raise AssertionError(
            f"face flux points do not coincide (max gap "
            f"{np.sqrt(d2[np.arange(len(perm)), perm]).max():.3e})")
    return perm


def match_fpts_grouped(pf_flat: np.ndarray, sls: list, srs: list,
                       tol: float = 1e-7) -> list:
    """Batched match_fpts over many faces, grouped by flux-point count;
    dispatches to the native kernel (native/mesh_kernels.cc hf_match_fpts)
    with a per-face numpy fallback."""
    from .. import native
    perms = [None] * len(sls)
    groups: dict[int, list] = {}
    for f, s in enumerate(sls):
        groups.setdefault(s.size, []).append(f)
    for nfp, idxs in groups.items():
        pl = pf_flat[np.stack([sls[f] for f in idxs])]
        pr = pf_flat[np.stack([srs[f] for f in idxs])]
        try:
            p = native.match_fpts_native(pl, pr, tol)
        except AssertionError:
            p = None   # fall through for the detailed per-face error
        if p is None:
            for j, f in enumerate(idxs):
                perms[f] = match_fpts(pl[j], pr[j], tol)
        else:
            for j, f in enumerate(idxs):
                perms[f] = p[j]
    return perms


@dataclasses.dataclass
class ElementBlock:
    """One element type's geometry + connectivity, ready for the jitted
    residual.  All arrays numpy; the residual factory casts to jnp."""

    ops: ElementOps
    n_eles: int
    # volume geometry
    pos_upts: np.ndarray      # (E, U, d)
    detjac_upts: np.ndarray   # (E, U)
    jginv_upts: np.ndarray    # (E, U, d, d)
    # face geometry (flattened slots, S = E * Pf)
    pos_fpts: np.ndarray      # (S, d)
    tdA_fpts: np.ndarray      # (S,)
    norm_fpts: np.ndarray     # (S, d)
    detjac_fpts: np.ndarray   # (S,)
    jginv_fpts: np.ndarray    # (S, d, d)
    # face connectivity
    int_slot_l: np.ndarray    # (Fi, nfp)
    int_slot_r: np.ndarray    # (Fi, nfp)
    bdy_slot: np.ndarray      # (Fb, nfp)
    bdy_bcid: np.ndarray      # (Fb,)
    slot_src: np.ndarray      # (S,) index into concat fluxes ((Fi+Fb)*nfp)
    slot_sign: np.ndarray     # (S,) +1 / -1
    # error-norm machinery
    pos_vol_cubpts: np.ndarray    # (E, C, d)
    detjac_vol_cubpts: np.ndarray  # (E, C)
    # elements' reference length (for CFL dt), ref:src/eles_quads.cpp:1287-1301
    h_ref: np.ndarray         # (E,)
    # over-integration (de-aliasing) geometry, set when enabled
    # (ref:src/eles.cpp:4151-4213 set_transforms_over_int_cubtps)
    jginv_over: np.ndarray | None = None    # (E, C2, d, d)
    opp_over: np.ndarray | None = None      # (C2, U)
    over_filter: np.ndarray | None = None   # (U, C2)
    # wall distance (ref:src/geometry.cpp:708-894, ref:src/eles.cpp:2701)
    wall_dist_upts: np.ndarray | None = None   # (E, U)
    wall_dist_fpts: np.ndarray | None = None   # (S,)
    # validity masks for padded face rows (mixed face shapes, e.g. prisms)
    int_mask: np.ndarray | None = None   # (Fi, nfp_max) 1 = real fpt
    bdy_mask: np.ndarray | None = None   # (Fb, nfp_max)

    def compute_wall_distance(self, wall_pts: np.ndarray) -> None:
        """Min distance from every solution/flux point to the no-slip wall
        point cloud (the reference gathers global no-slip face points and
        scans, ref:src/geometry.cpp:708-894)."""
        if wall_pts.size == 0:
            E, U, _ = self.pos_upts.shape
            self.wall_dist_upts = np.full((E, U), 1e10)
            self.wall_dist_fpts = np.full(self.pos_fpts.shape[0], 1e10)
            return

        def min_dist(pts):
            # exact nearest neighbours through KD-trees, one per cluster
            # (wall_clusters)
            flat = pts.reshape(-1, pts.shape[-1])
            out = np.min([cKDTree(c).query(flat, workers=-1)[0]
                          for c in wall_clusters(wall_pts)], axis=0)
            return out.reshape(pts.shape[:-1])

        self.wall_dist_upts = min_dist(self.pos_upts)
        self.wall_dist_fpts = min_dist(self.pos_fpts)

    @property
    def n_upts(self):
        return self.ops.n_upts

    @property
    def n_fpts(self):
        return self.ops.n_fpts


def wall_clusters(pts: np.ndarray) -> list:
    """The point cloud ``pts`` (M, d) cut at every empty slab wider than a
    quarter of the cloud's largest extent (a channel's two walls),
    recursively.  A KD-tree over a cloud that spans such a slab keeps
    boxes across it that prune nothing for the points inside it (the
    channel cell's 11M solution and flux points took 35 s against one
    tree on an 8-core host; a tree a wall is about ten times faster).  The
    nearest distance is the least over the clusters', the same exact
    answer."""
    ext = np.ptp(pts, axis=0).max()
    for k in range(pts.shape[1]):
        s = np.unique(pts[:, k])
        if s.size > 1:
            gaps = np.diff(s)
            i = int(np.argmax(gaps))
            if gaps[i] > 0.25 * ext:
                lo = pts[:, k] < 0.5 * (s[i] + s[i + 1])
                return wall_clusters(pts[lo]) + wall_clusters(pts[~lo])
    return [pts]


def mesh_shape_points(mesh: MeshData, sel: np.ndarray | None = None):
    """(spts (E, n_spts, d), n_spts): shape points of the selected cells
    on one common layout.  Heterogeneous shape-point counts (e.g. linear
    interior cells + curved boundary cells of the same type) are upcast
    to the richest layout by evaluating each cell's own shape map at the
    rich layout's reference nodes — exact, since the rich basis contains
    the poorer map (the reference keeps n_spts per cell,
    ref:src/eles.cpp calc_pos / ref:src/mesh_reader.cpp:203-246)."""
    if sel is None:
        sel = np.arange(mesh.n_cells)
    ct = int(mesh.ctype[sel[0]])
    assert np.all(mesh.ctype[sel] == ct), (
        "mesh_shape_points: sel spans multiple element types; pass "
        "per-type selections (a mixed upcast would silently apply the "
        "wrong shape basis)")
    d = mesh.n_dims
    n_spts_all = mesh.c2n_v[sel]
    n_spts = int(n_spts_all.max())
    if np.all(n_spts_all == n_spts):
        return mesh.xv[mesh.c2v[sel][:, :n_spts]], n_spts
    from ..mesh.shape import shape_ref_locs
    rich = shape_ref_locs(ct, n_spts)
    spts = np.empty((sel.size, n_spts, d))
    for ns in np.unique(n_spts_all):
        m = n_spts_all == ns
        pts = mesh.xv[mesh.c2v[sel[m]][:, :int(ns)]]
        spts[m] = (pts if ns == n_spts else
                   np.einsum("qs,esd->eqd",
                             shape_basis(ct, rich, int(ns)), pts))
    return spts, n_spts


def build_element_block(mesh: MeshData, conn: FaceConnectivity,
                        ops: ElementOps, check_geometry: bool = True,
                        delta_cyclic: np.ndarray | None = None,
                        over_int_order: int | None = None,
                        sel: np.ndarray | None = None,
                        face_tables: bool = True) -> ElementBlock:
    """Assemble an ElementBlock.

    ``sel``: element subset of this type (defaults to all; mixed meshes pass
    per-type selections and build global face tables separately with
    ``face_tables=False``)."""
    ct = ops.ele_type
    if sel is None:
        sel = np.where(mesh.ctype == ct)[0]
        if sel.size != mesh.n_cells:
            raise NotImplementedError(
                "mixed-type meshes: use solver.multiblock.MixedSolver")
    E = sel.size
    d = ops.n_dims
    spts, n_spts = mesh_shape_points(mesh, sel)   # (E, n_spts, d)

    # --- volume transforms (ref:src/eles.cpp:4035-4148)
    sb_u = shape_basis(ct, ops.loc_upts, n_spts)          # (U, n_spts)
    db_u = shape_dbasis(ct, ops.loc_upts, n_spts)         # (U, n_spts, d)
    pos_upts = np.einsum("us,esd->eud", sb_u, spts)
    J_u = np.einsum("usj,esi->euij", db_u, spts)          # dx_i/dxi_j
    detjac_upts = np.linalg.det(J_u)
    if np.any(detjac_upts <= 0):
        raise ValueError("Negative Jacobian at solution points")
    jginv_upts = _adjugate(J_u)

    # --- face transforms (ref:src/eles.cpp:4215-4393)
    sb_f = shape_basis(ct, ops.tloc_fpts, n_spts)
    db_f = shape_dbasis(ct, ops.tloc_fpts, n_spts)
    pos_fpts = np.einsum("ps,esd->epd", sb_f, spts)       # (E, Pf, d)
    J_f = np.einsum("psj,esi->epij", db_f, spts)
    detjac_fpts = np.linalg.det(J_f)
    if np.any(detjac_fpts <= 0):
        raise ValueError("Negative Jacobian at flux points")
    jginv_fpts = _adjugate(J_f)
    # physical scaled normal = tnorm^T . adj(J) (ref:src/eles.cpp:4300-4312)
    scaled_norm = np.einsum("pi,epij->epj", ops.tnorm_fpts, jginv_fpts)
    tdA = np.linalg.norm(scaled_norm, axis=-1)            # (E, Pf)
    norm = scaled_norm / tdA[..., None]

    # --- volume cubature geometry for error norms (ref:src/eles.cpp:5076-5136)
    sb_c = shape_basis(ct, ops.loc_vol_cubpts, n_spts)
    db_c = shape_dbasis(ct, ops.loc_vol_cubpts, n_spts)
    pos_cub = np.einsum("cs,esd->ecd", sb_c, spts)
    J_c = np.einsum("csj,esi->ecij", db_c, spts)
    detjac_cub = np.linalg.det(J_c)

    # --- h_ref: per-type CFL length scale, matching the reference's
    # calc_h_ref_specific exactly: min edge for tensor-product elements,
    # incircle/insphere diameters for simplex-faced ones
    # (ref:src/eles_quads.cpp:1287-1301, eles_hexas.cpp, eles_tris.cpp:982,
    # eles_tets.cpp, eles_pris.cpp).
    def _tri_incircle_d(v0, v1, v2):
        """Incircle diameter 2*sqrt((s-a)(s-b)(s-c)/s) per element."""
        a = np.linalg.norm(v0 - v1, axis=-1)
        b = np.linalg.norm(v1 - v2, axis=-1)
        c = np.linalg.norm(v2 - v0, axis=-1)
        s = 0.5 * (a + b + c)
        return 2.0 * np.sqrt((s - a) * (s - b) * (s - c) / s)

    if ct == QUAD:
        corners = spts[:, _quad_corners(n_spts)]
        edges = [(0, 1), (1, 3), (3, 2), (2, 0)]
        h_ref = np.min(np.stack(
            [np.linalg.norm(corners[:, a] - corners[:, b], axis=-1)
             for a, b in edges]), axis=0)
    elif ct == HEX:
        corners = spts[:, _hex_corners(n_spts)]
        edges = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6),
                 (6, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
        h_ref = np.min(np.stack(
            [np.linalg.norm(corners[:, a] - corners[:, b], axis=-1)
             for a, b in edges]), axis=0)
    elif ct == TRI:
        c3 = spts[:, :3]
        h_ref = _tri_incircle_d(c3[:, 0], c3[:, 1], c3[:, 2])
    elif ct == TET:
        c4 = spts[:, :4]
        a = c4[:, 1] - c4[:, 0]
        b = c4[:, 2] - c4[:, 0]
        c = c4[:, 3] - c4[:, 0]
        dd = c4[:, 2] - c4[:, 1]
        e = c4[:, 3] - c4[:, 1]
        vol = np.einsum("ei,ei->e", np.cross(a, b), c) / 6.0
        s_a = 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)
        s_b = 0.5 * np.linalg.norm(np.cross(a, c), axis=-1)
        s_c = 0.5 * np.linalg.norm(np.cross(b, c), axis=-1)
        s_d = 0.5 * np.linalg.norm(np.cross(dd, e), axis=-1)
        h_ref = 6.0 * vol / (s_a + s_b + s_c + s_d)   # insphere diameter
    elif ct == PRISM:
        c6 = spts[:, :6]
        cand = [np.linalg.norm(c6[:, i] - c6[:, i + 3], axis=-1)
                for i in range(3)]
        cand.append(_tri_incircle_d(c6[:, 0], c6[:, 1], c6[:, 2]))
        cand.append(_tri_incircle_d(c6[:, 3], c6[:, 4], c6[:, 5]))
        h_ref = np.min(np.stack(cand), axis=0)
    else:
        raise NotImplementedError

    # --- face slot tables.  Faces of different shapes (prisms: tri + quad
    # faces) have different fpt counts; rows are padded to the max with
    # slot 0, whose flux entries are never referenced by slot_src.
    Pf = ops.n_fpts
    S = E * Pf
    if face_tables:
        fpt_off = np.concatenate([[0], np.cumsum(ops.n_fpts_per_face)])
        nfp_max = int(ops.n_fpts_per_face.max())

        def slots(ele, locf):
            nfp = int(ops.n_fpts_per_face[locf])
            return ele * Pf + fpt_off[locf] + np.arange(nfp)

        Fi = conn.int_ele_l.size
        pf_flat = pos_fpts.reshape(-1, d)
        int_slot_l = np.zeros((Fi, nfp_max), dtype=np.int64)
        int_slot_r = np.zeros((Fi, nfp_max), dtype=np.int64)
        int_mask = np.zeros((Fi, nfp_max))
        sls = [slots(conn.int_ele_l[f], conn.int_locf_l[f])
               for f in range(Fi)]
        srs = [slots(conn.int_ele_r[f], conn.int_locf_r[f])
               for f in range(Fi)]
        perms = match_fpts_grouped(pf_flat, sls, srs)
        for f in range(Fi):
            sl, sr0 = sls[f], srs[f]
            int_slot_l[f, :sl.size] = sl
            int_slot_r[f, :sl.size] = sr0[perms[f]]
            int_mask[f, :sl.size] = 1.0

        Fb = conn.bdy_ele.size
        bdy_slot = np.zeros((Fb, nfp_max), dtype=np.int64)
        bdy_mask = np.zeros((Fb, nfp_max))
        for f in range(Fb):
            sl = slots(conn.bdy_ele[f], conn.bdy_locf[f])
            bdy_slot[f, :sl.size] = sl
            bdy_mask[f, :sl.size] = 1.0

        # --- inverse slot map: one gather instead of scatter in the hot loop
        slot_src = -np.ones(S, dtype=np.int64)
        slot_sign = np.zeros(S)
        base = np.arange(Fi * nfp_max).reshape(Fi, nfp_max)
        ml = int_mask > 0
        slot_src[int_slot_l[ml]] = base[ml]
        slot_sign[int_slot_l[ml]] = 1.0
        slot_src[int_slot_r[ml]] = base[ml]
        slot_sign[int_slot_r[ml]] = -1.0
        if Fb:
            bbase = Fi * nfp_max + np.arange(Fb * nfp_max).reshape(Fb, nfp_max)
            mb = bdy_mask > 0
            slot_src[bdy_slot[mb]] = bbase[mb]
            slot_sign[bdy_slot[mb]] = 1.0
        if np.any(slot_src < 0):
            raise AssertionError(
                "uncovered flux-point slots; face tables broken")
        bdy_bcid = conn.bdy_bcid.copy()
    else:
        # mixed meshes: face tables live in the global slot space, built by
        # build_mixed_blocks
        z = np.zeros((0, 1), dtype=np.int64)
        int_slot_l = int_slot_r = bdy_slot = z
        int_mask = bdy_mask = np.zeros((0, 1))
        slot_src = np.zeros(0, dtype=np.int64)
        slot_sign = np.zeros(0)
        bdy_bcid = np.zeros(0, dtype=np.int64)

    # --- over-integration geometry (ref:src/eles.cpp:4151-4213)
    jginv_over = opp_over = over_filter = None
    if over_int_order is not None:
        loc_over, opp_over, over_filter = build_over_int_ops(
            ops, over_int_order)
        db_o = shape_dbasis(ct, loc_over, n_spts)
        J_o = np.einsum("csj,esi->ecij", db_o, spts)
        jginv_over = _adjugate(J_o)

    return ElementBlock(
        ops=ops, n_eles=E,
        jginv_over=jginv_over, opp_over=opp_over, over_filter=over_filter,
        pos_upts=pos_upts, detjac_upts=detjac_upts, jginv_upts=jginv_upts,
        pos_fpts=pos_fpts.reshape(S, d), tdA_fpts=tdA.reshape(S),
        norm_fpts=norm.reshape(S, d), detjac_fpts=detjac_fpts.reshape(S),
        jginv_fpts=jginv_fpts.reshape(S, d, d),
        int_slot_l=int_slot_l, int_slot_r=int_slot_r,
        bdy_slot=bdy_slot, bdy_bcid=bdy_bcid,
        int_mask=int_mask, bdy_mask=bdy_mask,
        slot_src=slot_src, slot_sign=slot_sign,
        pos_vol_cubpts=pos_cub, detjac_vol_cubpts=detjac_cub, h_ref=h_ref)


@dataclasses.dataclass
class MixedMeshTables:
    """Face tables for a mixed-type mesh in a GLOBAL slot space.

    The global slot of flux point j on local face locf of global element e is
      slot_off[ctype[e]] + loc_idx[e] * Pf_ct + fpt_off_ct[locf] + j
    so per-type flux-point data concatenated in ``cts`` order lines up with
    the global face gather tables.  This generalizes the reference's
    per-pairing inters machinery (ref:src/int_inters.cpp:67-121,
    ref:src/geometry.cpp:250-420 which wires tris/quads/... into shared
    inters objects) to one flat index space.
    """
    cts: list                     # element types present, ascending
    blocks: dict                  # ct -> ElementBlock (no local face tables)
    sels: dict                    # ct -> global element ids of that type
    slot_off: dict                # ct -> global slot offset of the block
    n_slots: int
    # global face-side geometry (concat of per-block flats, cts order)
    pos_fpts: np.ndarray          # (S, d)
    tdA_fpts: np.ndarray          # (S,)
    norm_fpts: np.ndarray         # (S, d)
    detjac_fpts: np.ndarray       # (S,)
    jginv_fpts: np.ndarray        # (S, d, d)
    # global face tables (same semantics as ElementBlock's)
    int_slot_l: np.ndarray
    int_slot_r: np.ndarray
    int_mask: np.ndarray
    bdy_slot: np.ndarray
    bdy_bcid: np.ndarray
    bdy_mask: np.ndarray
    slot_src: np.ndarray
    slot_sign: np.ndarray


def mixed_type_selections(mesh: MeshData, conn: FaceConnectivity) -> dict:
    """Per-type global element ids, ordered so STRUCTURALLY IDENTICAL
    elements (same multiset of face-pairing patterns) are contiguous.

    The SoA face groups key on those patterns; with global-cell ordering
    the types interleave (e.g. upper/lower split tris alternate) and
    every group's element gather is strided.  Sorting each type by a
    face-pattern signature (side, own locf, partner locf, partner type /
    bc id — stable, so ties keep mesh order) turns the group gathers
    into contiguous slices.  Pure renumbering: sels stays the single
    source of truth for state/IO order, physics unchanged."""
    nfmax = max(int(n) for n in
                np.concatenate([conn.int_locf_l, conn.int_locf_r,
                                conn.bdy_locf, [0]])) + 1
    C = mesh.n_cells
    codes = np.full((C, nfmax), -1, dtype=np.int64)
    cnt = np.zeros(C, dtype=np.int64)

    def add(ele, code):
        ele = np.asarray(ele)
        for e, c in zip(ele, np.asarray(code)):
            codes[e, cnt[e]] = c
            cnt[e] += 1

    ct_of = mesh.ctype
    enc = lambda side, lf_s, lf_o, rot, other: (
        (((side * 64 + lf_s) * 64 + lf_o) * 64
         + np.minimum(rot, 63)) * 4096 + other)
    add(conn.int_ele_l, enc(0, conn.int_locf_l, conn.int_locf_r,
                            conn.int_rot, ct_of[conn.int_ele_r]))
    add(conn.int_ele_r, enc(1, conn.int_locf_r, conn.int_locf_l,
                            conn.int_rot, ct_of[conn.int_ele_l]))
    if conn.bdy_ele.size:
        add(conn.bdy_ele, enc(2, conn.bdy_locf, 0, 0,
                              np.minimum(conn.bdy_bcid, 4095)))
    codes = -np.sort(-codes, axis=1)            # canonical per-element order
    sels = {}
    for ct in sorted(int(c) for c in np.unique(mesh.ctype)):
        sel = np.where(mesh.ctype == ct)[0]
        # lexsort: LAST key is primary -> signature first, mesh order ties
        order = np.lexsort((sel,) + tuple(codes[sel, k]
                                          for k in reversed(range(nfmax))))
        sels[ct] = sel[order]
    return sels


def build_mixed_blocks(mesh: MeshData, conn: FaceConnectivity,
                       ops_by_ct: dict, check_geometry: bool = True,
                       over_int_order: int | None = None) -> MixedMeshTables:
    """Per-type geometry blocks + global-slot face tables for a mixed mesh."""
    cts = sorted(int(c) for c in np.unique(mesh.ctype))
    blocks, sels, slot_off = {}, {}, {}
    off = 0
    loc_idx = np.zeros(mesh.n_cells, dtype=np.int64)
    sig_sels = mixed_type_selections(mesh, conn)
    for ct in cts:
        sel = sig_sels[ct]
        sels[ct] = sel
        loc_idx[sel] = np.arange(sel.size)
        blocks[ct] = build_element_block(
            mesh, None, ops_by_ct[ct], check_geometry=check_geometry,
            over_int_order=over_int_order, sel=sel, face_tables=False)
        slot_off[ct] = off
        off += sel.size * ops_by_ct[ct].n_fpts
    S = off
    d = mesh.n_dims

    pos_fpts = np.concatenate([blocks[ct].pos_fpts for ct in cts])
    tdA_fpts = np.concatenate([blocks[ct].tdA_fpts for ct in cts])
    norm_fpts = np.concatenate([blocks[ct].norm_fpts for ct in cts])
    detjac_fpts = np.concatenate([blocks[ct].detjac_fpts for ct in cts])
    jginv_fpts = np.concatenate([blocks[ct].jginv_fpts for ct in cts])

    fpt_off = {ct: np.concatenate([[0],
                                   np.cumsum(ops_by_ct[ct].n_fpts_per_face)])
               for ct in cts}
    nfp_max = max(int(ops_by_ct[ct].n_fpts_per_face.max()) for ct in cts)

    def slots(ele, locf):
        ct = int(mesh.ctype[ele])
        ops = ops_by_ct[ct]
        nfp = int(ops.n_fpts_per_face[locf])
        return (slot_off[ct] + loc_idx[ele] * ops.n_fpts
                + fpt_off[ct][locf] + np.arange(nfp))

    Fi = conn.int_ele_l.size
    int_slot_l = np.zeros((Fi, nfp_max), dtype=np.int64)
    int_slot_r = np.zeros((Fi, nfp_max), dtype=np.int64)
    int_mask = np.zeros((Fi, nfp_max))
    sls = [slots(conn.int_ele_l[f], conn.int_locf_l[f]) for f in range(Fi)]
    srs = [slots(conn.int_ele_r[f], conn.int_locf_r[f]) for f in range(Fi)]
    for f in range(Fi):
        if sls[f].size != srs[f].size:
            raise AssertionError(
                "face fpt-count mismatch across element types; use matching "
                "face point sets (fpts_type) on both types")
    perms = match_fpts_grouped(pos_fpts, sls, srs)
    for f in range(Fi):
        sl, sr0 = sls[f], srs[f]
        int_slot_l[f, :sl.size] = sl
        int_slot_r[f, :sl.size] = sr0[perms[f]]
        int_mask[f, :sl.size] = 1.0

    Fb = conn.bdy_ele.size
    bdy_slot = np.zeros((Fb, nfp_max), dtype=np.int64)
    bdy_mask = np.zeros((Fb, nfp_max))
    for f in range(Fb):
        sl = slots(conn.bdy_ele[f], conn.bdy_locf[f])
        bdy_slot[f, :sl.size] = sl
        bdy_mask[f, :sl.size] = 1.0

    slot_src = -np.ones(S, dtype=np.int64)
    slot_sign = np.zeros(S)
    base = np.arange(Fi * nfp_max).reshape(Fi, nfp_max)
    ml = int_mask > 0
    slot_src[int_slot_l[ml]] = base[ml]
    slot_sign[int_slot_l[ml]] = 1.0
    slot_src[int_slot_r[ml]] = base[ml]
    slot_sign[int_slot_r[ml]] = -1.0
    if Fb:
        bbase = Fi * nfp_max + np.arange(Fb * nfp_max).reshape(Fb, nfp_max)
        mb = bdy_mask > 0
        slot_src[bdy_slot[mb]] = bbase[mb]
        slot_sign[bdy_slot[mb]] = 1.0
    if np.any(slot_src < 0):
        raise AssertionError("uncovered flux-point slots in mixed tables")

    return MixedMeshTables(
        cts=cts, blocks=blocks, sels=sels, slot_off=slot_off, n_slots=S,
        pos_fpts=pos_fpts, tdA_fpts=tdA_fpts, norm_fpts=norm_fpts,
        detjac_fpts=detjac_fpts, jginv_fpts=jginv_fpts,
        int_slot_l=int_slot_l, int_slot_r=int_slot_r, int_mask=int_mask,
        bdy_slot=bdy_slot, bdy_bcid=conn.bdy_bcid.copy(), bdy_mask=bdy_mask,
        slot_src=slot_src, slot_sign=slot_sign)


def _quad_corners(n_spts):
    n1 = int(round(np.sqrt(n_spts)))
    if n1 * n1 == n_spts:
        # tensor ordering corners: bl, br, tl, tr
        return [0, n1 - 1, n_spts - n1, n_spts - 1]
    if n_spts == 8:
        return [0, 1, 3, 2]
    raise NotImplementedError


def _hex_corners(n_spts):
    n1 = int(round(n_spts ** (1 / 3)))
    if n1**3 == n_spts:
        s = n1 * n1 * (n1 - 1)
        return [0, n1 - 1, n1 * (n1 - 1), n1 * n1 - 1,
                s, s + n1 - 1, s + n1 * (n1 - 1), n_spts - 1]
    if n_spts == 20:
        return [0, 1, 3, 2, 4, 5, 7, 6]
    raise NotImplementedError
