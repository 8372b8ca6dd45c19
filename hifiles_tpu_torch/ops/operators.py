"""Per-element-type FR operator factory.

Builds, in float64 numpy, every small dense operator matrix the solver
applies as batched tensor contractions:

  opp_0 (Pf, U): solution at upts -> solution at fpts (ref:src/eles.cpp:3074)
  opp_1 (d, Pf, U): transformed flux -> *normal* transformed flux at fpts
       = opp_0 scaled by tnorm (ref:src/eles.cpp:3143)
  opp_2 (d, U, U): nodal derivative matrices (ref:src/eles.cpp:3228)
  opp_3 (U, Pf): the VCJH lift — divergence of the correction functions
       (ref:src/eles.cpp:3321, per-type fill_opp_3)
  opp_4 == opp_2 (ref:src/eles.cpp:3371)
  opp_5 (d, U, Pf) = opp_3 * tnorm[d] (ref:src/eles.cpp:3451-3476)
  opp_6 == opp_0 (ref:src/eles.cpp:3537-3555)
  opp_volume_cubpts, opp_p, opp_r: interpolations to cubature/plot/restart pts

TPU-first fused forms (exact linear-algebra identities, so physics parity is
preserved up to f64 rounding):

  opp_div  (U, U*d)  = concat_d opp_2[d]        — one volume GEMM
  opp_corr (U, Pf)   = opp_3                    — one surface GEMM
  opp_div_fused = opp_div - opp_3 @ opp_1_cat   — folds the discontinuous
       -normal-flux subtraction of calculate_corrected_divergence
       (ref:src/eles.cpp:1738-1817) into the volume operator, removing an
       entire (Pf, U) GEMM and the fpts round-trip of the discontinuous flux.

Copied from hifiles_tpu/ops/operators.py (lines 1-694) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import HEX, PRISM, QUAD, TET, TRI
from .basis import (dlagrange_matrix, lagrange_matrix, tensor_legendre_norms,
                    vandermonde_tensor)
from .correction import dcorrection_1d
from .quadrature import GAUSS, line_rule, tensor_rule


@dataclasses.dataclass(frozen=True)
class ElementOps:
    """All reference-domain operators for one (element type, order) pair.

    Everything is numpy float64; the solver casts to its compute dtype and
    closes over these as constants under jit.
    """

    ele_type: int
    order: int
    n_dims: int
    n_upts: int
    n_fpts: int                 # total flux points per element
    n_faces: int
    n_fpts_per_face: np.ndarray  # (n_faces,)
    loc_upts: np.ndarray        # (U, d)
    tloc_fpts: np.ndarray       # (Pf, d)
    tnorm_fpts: np.ndarray      # (Pf, d) reference-domain outward normals
    fpt_face: np.ndarray        # (Pf,) which local face each fpt lies on
    opp_0: np.ndarray           # (Pf, U)
    opp_1: np.ndarray           # (d, Pf, U)
    opp_2: np.ndarray           # (d, U, U)
    opp_3: np.ndarray           # (U, Pf)
    # volume cubature (for error norms & integral diagnostics)
    loc_vol_cubpts: np.ndarray  # (C, d)
    w_vol_cubpts: np.ndarray    # (C,)
    opp_vol_cubpts: np.ndarray  # (C, U)
    # modal machinery (shock capture, filters, over-integration)
    vandermonde: np.ndarray     # (U, U) hierarchical tensor-Legendre
    inv_vandermonde: np.ndarray
    modal_norms: np.ndarray     # (U,) Persson norms
    # fused fast-path operators
    opp_div_fused: np.ndarray   # (U, U*d)
    upts_weights: np.ndarray    # (U,) quadrature weights at solution points
    # per-flux-point quadrature weight on its face (for surface integrals,
    # ref:src/eles.cpp:5704 compute_wall_forces at inters_cubpts)
    fpt_weights: np.ndarray | None = None
    # custom nodal interpolation (hybrid bases, e.g. prisms)
    interp_fn: object = None

    @property
    def opp_1_cat(self) -> np.ndarray:
        """(Pf, U*d) concatenation of opp_1 over the dim axis."""
        return np.concatenate([self.opp_1[d] for d in range(self.n_dims)], axis=1)

    @property
    def opp_2_cat(self) -> np.ndarray:
        """(U, U*d) concatenation of opp_2 over the dim axis."""
        return np.concatenate([self.opp_2[d] for d in range(self.n_dims)], axis=1)

    def interp_to(self, locs: np.ndarray) -> np.ndarray:
        """Nodal interpolation matrix from upts to arbitrary points ``locs``.

        Covers opp_p / opp_probe / opp_r / opp_inters_cubpts
        (ref:src/eles.cpp:3600-3710)."""
        if self.interp_fn is not None:
            return self.interp_fn(locs)
        if self.ele_type == TRI:
            from .simplex import dubiner_2d
            return dubiner_2d(locs, self.order) @ self.inv_vandermonde
        if self.ele_type == TET:
            from .simplex import dubiner_3d
            return dubiner_3d(locs, self.order) @ self.inv_vandermonde
        return _nodal_interp_tensor(locs, self._loc_1d(), self.n_dims)

    def _loc_1d(self) -> np.ndarray:
        n = self.order + 1
        return self.loc_upts[:n, 0]


def _nodal_interp_tensor(locs: np.ndarray, loc_1d: np.ndarray, n_dims: int) -> np.ndarray:
    """Tensor-product Lagrange interpolation matrix (pts, U).

    Mode ordering matches eval_nodal_basis: x-fastest
    (ref:src/eles_quads.cpp:962-974, ref:src/eles_hexas.cpp analog).
    """
    locs = np.atleast_2d(np.asarray(locs, dtype=np.float64))
    Ls = [lagrange_matrix(locs[:, ax], loc_1d) for ax in range(n_dims)]
    n = loc_1d.size
    npts = locs.shape[0]
    out = np.empty((npts, n**n_dims))
    if n_dims == 2:
        for i in range(n):
            for j in range(n):
                out[:, j + n * i] = Ls[0][:, j] * Ls[1][:, i]
    elif n_dims == 3:
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    out[:, k + n * j + n * n * i] = (
                        Ls[0][:, k] * Ls[1][:, j] * Ls[2][:, i])
    else:
        raise ValueError(n_dims)
    return out


def _nodal_deriv_tensor(locs: np.ndarray, loc_1d: np.ndarray, n_dims: int,
                        axis: int) -> np.ndarray:
    """d/d(axis) of the tensor nodal basis at ``locs`` (pts, U)."""
    locs = np.atleast_2d(np.asarray(locs, dtype=np.float64))
    mats = []
    for ax in range(n_dims):
        if ax == axis:
            mats.append(dlagrange_matrix(locs[:, ax], loc_1d))
        else:
            mats.append(lagrange_matrix(locs[:, ax], loc_1d))
    n = loc_1d.size
    npts = locs.shape[0]
    out = np.empty((npts, n**n_dims))
    if n_dims == 2:
        for i in range(n):
            for j in range(n):
                out[:, j + n * i] = mats[0][:, j] * mats[1][:, i]
    elif n_dims == 3:
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    out[:, k + n * j + n * n * i] = (
                        mats[0][:, k] * mats[1][:, j] * mats[2][:, i])
    else:
        raise ValueError(n_dims)
    return out


def _quad_fpts(loc_1d: np.ndarray, order: int):
    """Quad flux-point locations/normals (ref:src/eles_quads.cpp:209-247,389-425).

    Face order: 0 bottom (+x traverse), 1 right (+y), 2 top (-x), 3 left (-y);
    all CCW around the element, outward reference normals.
    """
    n = order + 1
    pts, nrm, face = [], [], []
    for i in range(4):
        for j in range(n):
            if i == 0:
                pts.append((loc_1d[j], -1.0)); nrm.append((0.0, -1.0))
            elif i == 1:
                pts.append((1.0, loc_1d[j])); nrm.append((1.0, 0.0))
            elif i == 2:
                pts.append((loc_1d[order - j], 1.0)); nrm.append((0.0, 1.0))
            else:
                pts.append((-1.0, loc_1d[order - j])); nrm.append((-1.0, 0.0))
            face.append(i)
    return (np.array(pts), np.array(nrm), np.array(face, dtype=np.int64))


def _hex_fpts(loc_1d: np.ndarray, order: int):
    """Hex flux-point locations/normals (ref:src/eles_hexas.cpp:224-282,
    set_tnorm_fpts analog).  fpt = k + n*j + n*n*face."""
    n = order + 1
    pts, nrm, face = [], [], []
    normals = [(0, 0, -1), (0, -1, 0), (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, 0, 1)]
    for i in range(6):
        for j in range(n):
            for k in range(n):
                if i == 0:
                    p = (loc_1d[order - k], loc_1d[j], -1.0)
                elif i == 1:
                    p = (loc_1d[k], -1.0, loc_1d[j])
                elif i == 2:
                    p = (1.0, loc_1d[k], loc_1d[j])
                elif i == 3:
                    p = (loc_1d[order - k], 1.0, loc_1d[j])
                elif i == 4:
                    p = (-1.0, loc_1d[order - k], loc_1d[j])
                else:
                    p = (loc_1d[k], loc_1d[j], 1.0)
                pts.append(p)
                nrm.append(normals[i])
                face.append(i)
    return (np.array(pts, dtype=np.float64), np.array(nrm, dtype=np.float64),
            np.array(face, dtype=np.int64))


def _fill_opp3_quad(loc_upts, loc_1d, order, scheme, eta):
    """ref:src/eles_quads.cpp:1192-1268 (eval_div_vcjh_basis)."""
    n = order + 1
    U = loc_upts.shape[0]
    opp3 = np.empty((U, 4 * n))
    lx = lagrange_matrix(loc_upts[:, 0], loc_1d)   # (U, n)
    ly = lagrange_matrix(loc_upts[:, 1], loc_1d)
    gl_x = dcorrection_1d(loc_upts[:, 0], 0, order, scheme, eta)
    gr_x = dcorrection_1d(loc_upts[:, 0], 1, order, scheme, eta)
    gl_y = dcorrection_1d(loc_upts[:, 1], 0, order, scheme, eta)
    gr_y = dcorrection_1d(loc_upts[:, 1], 1, order, scheme, eta)
    for idx in range(4 * n):
        i, j = idx // n, idx % n
        if i == 0:
            opp3[:, idx] = -lx[:, j] * gl_y
        elif i == 1:
            opp3[:, idx] = ly[:, j] * gr_x
        elif i == 2:
            opp3[:, idx] = lx[:, order - j] * gr_y
        else:
            opp3[:, idx] = -ly[:, order - j] * gl_x
    return opp3


def _fill_opp3_hex(loc_upts, loc_1d, order, scheme, eta):
    """ref:src/eles_hexas.cpp:1444-1533 (eval_div_vcjh_basis)."""
    n = order + 1
    U = loc_upts.shape[0]
    opp3 = np.empty((U, 6 * n * n))
    L = [lagrange_matrix(loc_upts[:, ax], loc_1d) for ax in range(3)]
    gl = [dcorrection_1d(loc_upts[:, ax], 0, order, scheme, eta) for ax in range(3)]
    gr = [dcorrection_1d(loc_upts[:, ax], 1, order, scheme, eta) for ax in range(3)]
    nn = n * n
    for idx in range(6 * nn):
        i = idx // nn
        j = (idx - nn * i) // n
        k = idx - nn * i - n * j
        if i == 0:
            opp3[:, idx] = -L[0][:, order - k] * L[1][:, j] * gl[2]
        elif i == 1:
            opp3[:, idx] = -L[0][:, k] * L[2][:, j] * gl[1]
        elif i == 2:
            opp3[:, idx] = L[1][:, k] * L[2][:, j] * gr[0]
        elif i == 3:
            opp3[:, idx] = L[0][:, order - k] * L[2][:, j] * gr[1]
        elif i == 4:
            opp3[:, idx] = -L[1][:, order - k] * L[2][:, j] * gl[0]
        else:
            opp3[:, idx] = L[0][:, k] * L[1][:, j] * gr[2]
    return opp3


def build_tensor_ops(ele_type: int, order: int, upts_rule: int = GAUSS,
                     vcjh_scheme: int = 1, eta: float = 0.0) -> ElementOps:
    """Build the full operator set for QUAD (2-D) or HEX (3-D) elements."""
    if ele_type == QUAD:
        n_dims = 2
    elif ele_type == HEX:
        n_dims = 3
    else:
        raise ValueError("build_tensor_ops handles QUAD and HEX only")

    loc_1d, w_1d = line_rule(upts_rule, order)
    loc_upts, w_upts = tensor_rule(upts_rule, order, n_dims)
    n = order + 1
    U = n**n_dims

    if ele_type == QUAD:
        tloc_fpts, tnorm_fpts, fpt_face = _quad_fpts(loc_1d, order)
        n_faces = 4
        opp_3 = _fill_opp3_quad(loc_upts, loc_1d, order, vcjh_scheme, eta)
    else:
        tloc_fpts, tnorm_fpts, fpt_face = _hex_fpts(loc_1d, order)
        n_faces = 6
        opp_3 = _fill_opp3_hex(loc_upts, loc_1d, order, vcjh_scheme, eta)

    Pf = tloc_fpts.shape[0]
    opp_0 = _nodal_interp_tensor(tloc_fpts, loc_1d, n_dims)
    opp_1 = np.stack([opp_0 * tnorm_fpts[:, d:d + 1] for d in range(n_dims)])
    opp_2 = np.stack([_nodal_deriv_tensor(loc_upts, loc_1d, n_dims, d)
                      for d in range(n_dims)])

    # volume cubature at rule order = solution order (Gauss)
    # (ref:src/eles_quads.cpp:317-330)
    loc_cub, w_cub = tensor_rule(GAUSS, order, n_dims)
    opp_cub = _nodal_interp_tensor(loc_cub, loc_1d, n_dims)

    V = vandermonde_tensor(loc_upts, order)
    Vinv = np.linalg.inv(V)
    norms = tensor_legendre_norms(order, n_dims)

    opp_2_cat = np.concatenate([opp_2[d] for d in range(n_dims)], axis=1)
    opp_1_cat = np.concatenate([opp_1[d] for d in range(n_dims)], axis=1)
    opp_div_fused = opp_2_cat - opp_3 @ opp_1_cat

    # per-fpt face-quadrature weights (1-D rule per edge / tensor per face)
    if n_dims == 2:
        fpt_w = np.tile(w_1d, n_faces)
    else:
        w2 = np.outer(w_1d, w_1d).ravel()
        fpt_w = np.tile(w2, n_faces)

    return ElementOps(
        ele_type=ele_type, order=order, n_dims=n_dims, n_upts=U, n_fpts=Pf,
        fpt_weights=fpt_w,
        n_faces=n_faces,
        n_fpts_per_face=np.full(n_faces, Pf // n_faces, dtype=np.int64),
        loc_upts=loc_upts, tloc_fpts=tloc_fpts, tnorm_fpts=tnorm_fpts,
        fpt_face=fpt_face, opp_0=opp_0, opp_1=opp_1, opp_2=opp_2, opp_3=opp_3,
        loc_vol_cubpts=loc_cub, w_vol_cubpts=w_cub, opp_vol_cubpts=opp_cub,
        vandermonde=V, inv_vandermonde=Vinv, modal_norms=norms,
        opp_div_fused=opp_div_fused, upts_weights=w_upts)


_C_PLUS_1D = {2: 0.206, 3: 3.80e-3, 4: 4.67e-5, 5: 4.28e-7}
_C_PLUS_TRI = {2: 3.13e-2, 3: 4.67e-4, 4: 6.55e-6}
_C_PLUS_TET = {2: 3.07e-2, 3: 5.44e-4, 4: 9.92e-6, 5: 1.10e-7}


def _vcjh_c_simplex(order: int, c_user: float, scheme: int,
                    c_plus_tbl: dict) -> float:
    """Resolve the simplex VCJH constant per scheme
    (ref:src/funcs.cpp:743-800, ref:src/eles_tets.cpp:1333-1390):
    0 user c, 1 DG, 2 SD-like, 3 HU-like, 4 c+."""
    from math import factorial
    if scheme == 1:
        return 0.0
    if scheme == 0:
        return c_user
    if order not in _C_PLUS_1D or order not in c_plus_tbl:
        raise ValueError(f"C+ scheme tables stop before order {order}")
    ap = factorial(2 * order) / (2.0 ** order
                                 * factorial(order) ** 2)
    fap = factorial(order) * ap
    c_sd_1d = (2 * order) / ((2 * order + 1) * (order + 1) * fap * fap)
    c_hu_1d = (2 * (order + 1)) / ((2 * order + 1) * order * fap * fap)
    c_plus = c_plus_tbl[order]
    if scheme == 2:
        return c_sd_1d / _C_PLUS_1D[order] * c_plus
    if scheme == 3:
        return c_hu_1d / _C_PLUS_1D[order] * c_plus
    if scheme == 4:
        return c_plus
    raise ValueError(f"VCJH simplex scheme {scheme}")


def vcjh_filter_tri(V: np.ndarray, Vinv: np.ndarray, loc_upts: np.ndarray,
                    order: int, c: float) -> np.ndarray:
    """Tri VCJH filter Filt = (I + V V^T K)^-1 with
    K = sum_k c*C(order,k)/n * (Ds^k Dr^(order-k))^T (Ds^k Dr^(order-k))
    (ref:src/funcs.cpp:717-886 compute_filt_matrix_tri); the VCJH lift is
    Filt @ the DG lift (ref:src/funcs.cpp:630-643 get_opp_3_tri)."""
    from math import comb
    from .simplex import grad_dubiner_2d
    n = V.shape[0]
    if c == 0.0:
        return np.eye(n)
    gV = grad_dubiner_2d(loc_upts, order)
    Dr = gV[..., 0] @ Vinv
    Ds = gV[..., 1] @ Vinv
    K = np.zeros((n, n))
    for k in range(order + 1):
        D = np.eye(n)
        for _ in range(k):
            D = D @ Ds
        for _ in range(order - k):
            D = D @ Dr
        K += (c * comb(order, k) / n) * (D.T @ D)
    return np.linalg.inv(np.eye(n) + V @ V.T @ K)


def vcjh_filter_tet(V: np.ndarray, Vinv: np.ndarray, loc_upts: np.ndarray,
                    order: int, c: float) -> np.ndarray:
    """Tet VCJH filter (ref:src/eles_tets.cpp:1305-1500
    compute_filt_matrix_tet): K sums Dr^(order-v+1) Ds^(v-w) Dt^(w-1)
    cross-derivative penalties with trinomial coefficients."""
    from math import comb
    from .simplex import grad_dubiner_3d
    n = V.shape[0]
    if c == 0.0:
        return np.eye(n)
    gV = grad_dubiner_3d(loc_upts, order)
    Dmats = [gV[..., d] @ Vinv for d in range(3)]
    Dr, Ds, Dt = Dmats
    K = np.zeros((n, n))
    for v in range(1, order + 2):
        for w in range(1, v + 1):
            coeff = (1.0 / n) * comb(order, v - 1) * comb(v - 1, w - 1)
            D = np.eye(n)
            for _ in range(order - v + 1):
                D = D @ Dr
            for _ in range(v - w):
                D = D @ Ds
            for _ in range(w - 1):
                D = D @ Dt
            K += c * coeff * (D.T @ D)
    return np.linalg.inv(np.eye(n) + V @ V.T @ K)


def build_tri_ops(order: int, upts_type: int = 0, fpts_type: int = 0,
                  vcjh_scheme: int = 1, c_tri: float = 0.0) -> ElementOps:
    """Operator set for TRI elements (ref:src/eles_tris.cpp:45-136).

    Solution points: alpha-optimized (upts_type 1) or interior cubature
    points (upts_type 0, which also carry weights); nodal basis defined via
    the orthonormal Dubiner modal basis and its Vandermonde (Hesthaven eq.
    3.3, ref:src/eles_tris.cpp:703-720).  Correction: VCJH filter applied
    to the DG lift (ref:src/funcs.cpp:630-643)."""
    from .simplex import (dubiner_2d, grad_dubiner_2d, tri_alpha_points,
                          tri_dg_lift, tri_fpts, tri_interior_cubature,
                          tri_modes)

    c_tri = _vcjh_c_simplex(order, c_tri, vcjh_scheme, _C_PLUS_TRI)

    U = (order + 1) * (order + 2) // 2
    if upts_type == 0:
        loc_upts, w_upts = tri_interior_cubature(order)
    else:
        loc_upts = tri_alpha_points(order)
        w_upts = np.zeros(U)

    loc_1d_fpts, w_1d_fpts = line_rule(fpts_type, order)
    tloc_fpts, tnorm_fpts, fpt_face = tri_fpts(loc_1d_fpts, order)
    Pf = tloc_fpts.shape[0]

    V = dubiner_2d(loc_upts, order)
    Vinv = np.linalg.inv(V)
    # nodal basis value at x: phi(x) @ Vinv (columns = nodal functions)
    opp_0 = dubiner_2d(tloc_fpts, order) @ Vinv
    opp_1 = np.stack([opp_0 * tnorm_fpts[:, d:d + 1] for d in range(2)])
    gV = grad_dubiner_2d(loc_upts, order)             # (U, U, 2)
    opp_2 = np.stack([gV[..., d] @ Vinv for d in range(2)])
    opp_3 = vcjh_filter_tri(V, Vinv, loc_upts, order, c_tri) \
        @ tri_dg_lift(loc_upts, loc_1d_fpts, order)

    loc_cub, w_cub = tri_interior_cubature(min(order, 7))
    opp_cub = dubiner_2d(loc_cub, order) @ Vinv

    modes = np.array(tri_modes(order))
    norms = np.ones(U)  # Dubiner basis is orthonormal

    opp_2_cat = np.concatenate([opp_2[d] for d in range(2)], axis=1)
    opp_1_cat = np.concatenate([opp_1[d] for d in range(2)], axis=1)
    opp_div_fused = opp_2_cat - opp_3 @ opp_1_cat

    # face-quadrature weights including the reference-edge measure: the
    # hypotenuse has reference length 2*sqrt(2) over parameter range 2
    fpt_w = np.concatenate([w_1d_fpts, w_1d_fpts * np.sqrt(2.0), w_1d_fpts])

    return ElementOps(
        ele_type=TRI, order=order, n_dims=2, n_upts=U, n_fpts=Pf, n_faces=3,
        fpt_weights=fpt_w,
        n_fpts_per_face=np.full(3, order + 1, dtype=np.int64),
        loc_upts=loc_upts, tloc_fpts=tloc_fpts, tnorm_fpts=tnorm_fpts,
        fpt_face=fpt_face, opp_0=opp_0, opp_1=opp_1, opp_2=opp_2, opp_3=opp_3,
        loc_vol_cubpts=loc_cub, w_vol_cubpts=w_cub, opp_vol_cubpts=opp_cub,
        vandermonde=V, inv_vandermonde=Vinv, modal_norms=norms,
        opp_div_fused=opp_div_fused, upts_weights=w_upts)


def build_tet_ops(order: int, upts_type: int = 0, fpts_type: int = 0,
                  vcjh_scheme: int = 1, c_tet: float = 0.0) -> ElementOps:
    """Operator set for TET elements (ref:src/eles_tets.cpp:45-140).

    Solution points: interior cubature (upts_type 0) or alpha-optimized
    (upts_type 1); flux points: a tri point set mapped to the 4 faces;
    nodal basis via the 3-D Dubiner Vandermonde; correction: DG lift
    (VCJH filter for c_tet != 0 not yet implemented)."""
    from .simplex import (dubiner_3d, grad_dubiner_3d, tet_alpha_points,
                          tet_dg_lift, tet_fpts, tet_interior_cubature,
                          tri_interior_cubature)

    c_tet = _vcjh_c_simplex(order, c_tet, vcjh_scheme, _C_PLUS_TET)

    U = (order + 1) * (order + 2) * (order + 3) // 6
    if upts_type == 0:
        loc_upts, w_upts = tet_interior_cubature(order)
    else:
        loc_upts = tet_alpha_points(order)
        w_upts = np.zeros(U)

    tloc_fpts, tnorm_fpts, fpt_face = tet_fpts(order, fpts_type)
    Pf = tloc_fpts.shape[0]
    nfp = Pf // 4

    V = dubiner_3d(loc_upts, order)
    Vinv = np.linalg.inv(V)
    opp_0 = dubiner_3d(tloc_fpts, order) @ Vinv
    opp_1 = np.stack([opp_0 * tnorm_fpts[:, d:d + 1] for d in range(3)])
    gV = grad_dubiner_3d(loc_upts, order)
    opp_2 = np.stack([gV[..., d] @ Vinv for d in range(3)])
    opp_3 = vcjh_filter_tet(V, Vinv, loc_upts, order, c_tet) \
        @ tet_dg_lift(loc_upts, tloc_fpts, order)

    loc_cub, w_cub = tet_interior_cubature(min(order, 6))
    opp_cub = dubiner_3d(loc_cub, order) @ Vinv

    norms = np.ones(U)      # orthonormal Dubiner
    opp_2_cat = np.concatenate([opp_2[d] for d in range(3)], axis=1)
    opp_1_cat = np.concatenate([opp_1[d] for d in range(3)], axis=1)
    opp_div_fused = opp_2_cat - opp_3 @ opp_1_cat

    # face quadrature weights: the tri cubature weights, oblique face
    # carries the sqrt(3) measure factor (ref:src/eles_tets.cpp:1263-1290)
    if fpts_type == 0:
        _, w_tri = tri_interior_cubature(order)
    else:
        raise NotImplementedError("alpha fpts carry no weights; "
                                  "use fpts_type_tet 0")
    fpt_w = np.concatenate([w_tri * np.sqrt(3.0), w_tri, w_tri, w_tri])

    return ElementOps(
        ele_type=TET, order=order, n_dims=3, n_upts=U, n_fpts=Pf, n_faces=4,
        n_fpts_per_face=np.full(4, nfp, dtype=np.int64),
        fpt_weights=fpt_w,
        loc_upts=loc_upts, tloc_fpts=tloc_fpts, tnorm_fpts=tnorm_fpts,
        fpt_face=fpt_face, opp_0=opp_0, opp_1=opp_1, opp_2=opp_2, opp_3=opp_3,
        loc_vol_cubpts=loc_cub, w_vol_cubpts=w_cub, opp_vol_cubpts=opp_cub,
        vandermonde=V, inv_vandermonde=Vinv, modal_norms=norms,
        opp_div_fused=opp_div_fused, upts_weights=w_upts)


def build_pri_ops(order: int, upts_type_tri: int = 0, upts_type_1d: int = 0,
                  vcjh_scheme_1d: int = 1, eta_pri: float = 0.0,
                  vcjh_scheme_tri: int = 1, c_tri: float = 0.0) -> ElementOps:
    """Operator set for PRISM elements (ref:src/eles_pris.cpp:45-140).

    Nodal basis = tri nodal basis (Dubiner-Vandermonde) x 1-D Lagrange in z;
    upt index = upt_1d * n_tri + upt_tri.  Faces: 0 bottom tri (z=-1,
    (x,y) = (s,r) swapped), 1 top tri, 2/3/4 quad faces on the tri edges
    (ref:src/eles_pris.cpp set_tloc_fpts).  Correction: tri DG lift on the
    quad faces x z-row delta, 1-D VCJH in z on the tri faces
    (ref:src/eles_pris.cpp:1323-1412 fill_opp_3)."""
    from .simplex import (dubiner_2d, grad_dubiner_2d, tri_alpha_points,
                          tri_dg_lift, tri_interior_cubature)

    c_tri = _vcjh_c_simplex(order, c_tri, vcjh_scheme_tri, _C_PLUS_TRI)

    if upts_type_tri == 0:
        tri_pts, w_tri = tri_interior_cubature(order)
    else:
        tri_pts = tri_alpha_points(order)
        w_tri = np.zeros(tri_pts.shape[0])
    z_1d, w_1d = line_rule(upts_type_1d, order)
    n_tri = tri_pts.shape[0]
    n1 = order + 1
    U = n_tri * n1

    loc_upts = np.empty((U, 3))
    w_upts = np.empty(U)
    for i1 in range(n1):
        for it in range(n_tri):
            loc_upts[i1 * n_tri + it] = (tri_pts[it, 0], tri_pts[it, 1],
                                         z_1d[i1])
            w_upts[i1 * n_tri + it] = w_tri[it] * w_1d[i1]

    V_tri = dubiner_2d(tri_pts, order)
    Vinv_tri = np.linalg.inv(V_tri)

    def interp(locs):
        locs = np.atleast_2d(np.asarray(locs, dtype=np.float64))
        Nt = dubiner_2d(locs[:, :2], order) @ Vinv_tri       # (p, n_tri)
        Lz = lagrange_matrix(locs[:, 2], z_1d)               # (p, n1)
        return np.einsum("pt,pz->pzt", Nt, Lz).reshape(locs.shape[0], U)

    def dinterp(locs, axis):
        locs = np.atleast_2d(np.asarray(locs, dtype=np.float64))
        if axis < 2:
            dNt = (grad_dubiner_2d(locs[:, :2], order)[..., axis]
                   @ Vinv_tri)
            Lz = lagrange_matrix(locs[:, 2], z_1d)
            return np.einsum("pt,pz->pzt", dNt, Lz).reshape(locs.shape[0], U)
        Nt = dubiner_2d(locs[:, :2], order) @ Vinv_tri
        dLz = dlagrange_matrix(locs[:, 2], z_1d)
        return np.einsum("pt,pz->pzt", Nt, dLz).reshape(locs.shape[0], U)

    # flux points (ref:src/eles_pris.cpp set_tloc_fpts)
    s2 = 1.0 / np.sqrt(2.0)
    pts, nrm, face = [], [], []
    for i in range(n_tri):   # face 0, (x,y) swapped
        pts.append((tri_pts[i, 1], tri_pts[i, 0], -1.0))
        nrm.append((0.0, 0.0, -1.0))
        face.append(0)
    for i in range(n_tri):   # face 1
        pts.append((tri_pts[i, 0], tri_pts[i, 1], 1.0))
        nrm.append((0.0, 0.0, 1.0))
        face.append(1)
    quad_norms = [(0.0, -1.0, 0.0), (s2, s2, 0.0), (-1.0, 0.0, 0.0)]
    for fq in range(3):
        for i in range(n1):
            for j in range(n1):
                if fq == 0:
                    p3 = (z_1d[j], -1.0, z_1d[i])
                elif fq == 1:
                    p3 = (z_1d[order - j], z_1d[j], z_1d[i])
                else:
                    p3 = (-1.0, z_1d[order - j], z_1d[i])
                pts.append(p3)
                nrm.append(quad_norms[fq])
                face.append(2 + fq)
    tloc_fpts = np.array(pts)
    tnorm_fpts = np.array(nrm)
    fpt_face = np.array(face, dtype=np.int64)
    Pf = tloc_fpts.shape[0]

    opp_0 = interp(tloc_fpts)
    opp_1 = np.stack([opp_0 * tnorm_fpts[:, d:d + 1] for d in range(3)])
    opp_2 = np.stack([dinterp(loc_upts, d) for d in range(3)])

    # --- opp_3 (ref:src/eles_pris.cpp:1323-1412)
    opp_3 = np.zeros((U, Pf))
    gl = dcorrection_1d(z_1d, 0, order, vcjh_scheme_1d, eta_pri)
    gr = dcorrection_1d(z_1d, 1, order, vcjh_scheme_1d, eta_pri)
    # face0_map: bottom-face fpt i at (s_i, r_i) -> tri upt index
    face0_map = np.empty(n_tri, dtype=np.int64)
    for i in range(n_tri):
        d2 = np.sum((tri_pts - np.array([tri_pts[i, 1], tri_pts[i, 0]]))**2,
                    axis=1)
        face0_map[i] = int(np.argmin(d2))
        assert d2[face0_map[i]] < 1e-20
    from .simplex import dubiner_2d as _dub2
    V_tri = _dub2(tri_pts, order)
    opp_3_tri = vcjh_filter_tri(V_tri, np.linalg.inv(V_tri), tri_pts,
                                order, c_tri) \
        @ tri_dg_lift(tri_pts, z_1d, order)   # tri edge fpts = z_1d set
    for upt in range(U):
        upt_1d, upt_tri = divmod(upt, n_tri)
        # tri faces
        for i in range(n_tri):
            if face0_map[i] == upt_tri:
                opp_3[upt, i] = -gl[upt_1d]
            if i == upt_tri:
                opp_3[upt, n_tri + i] = gr[upt_1d]
        # quad faces
        for fq in range(3):
            base = 2 * n_tri + fq * n1 * n1
            for i in range(n1):
                if i != upt_1d:
                    continue
                for j in range(n1):
                    opp_3[upt, base + i * n1 + j] = \
                        opp_3_tri[upt_tri, fq * n1 + j]

    # volume cubature: tri interior x 1-D Gauss
    tri_c, w_tc = tri_interior_cubature(min(order, 7))
    zc, wzc = line_rule(GAUSS, order)
    loc_cub = np.array([(r, s, z) for z in zc for (r, s) in tri_c])
    w_cub = np.array([wt * wz for wz in wzc for wt in w_tc])
    opp_cub = interp(loc_cub)

    # modal machinery: Dubiner_tri x Legendre_z
    from .basis import legendre
    V = np.empty((U, U))
    norms = np.empty(U)
    for k in range(n1):
        Pk = legendre(loc_upts[:, 2], k)
        for m in range(n_tri):
            col = k * n_tri + m
            V[:, col] = (dubiner_2d(loc_upts[:, :2], order)[:, m] * Pk)
            norms[col] = 2.0 / (2.0 * k + 1.0)
    Vinv = np.linalg.inv(V)

    opp_2_cat = np.concatenate([opp_2[d] for d in range(3)], axis=1)
    opp_1_cat = np.concatenate([opp_1[d] for d in range(3)], axis=1)
    opp_div_fused = opp_2_cat - opp_3 @ opp_1_cat

    w_q = np.outer(w_1d, w_1d).ravel()
    fpt_w = np.concatenate([w_tri, w_tri, w_q, w_q * np.sqrt(2.0), w_q])

    return ElementOps(
        ele_type=PRISM, order=order, n_dims=3, n_upts=U, n_fpts=Pf,
        n_faces=5,
        n_fpts_per_face=np.array([n_tri, n_tri, n1 * n1, n1 * n1, n1 * n1],
                                 dtype=np.int64),
        fpt_weights=fpt_w, interp_fn=interp,
        loc_upts=loc_upts, tloc_fpts=tloc_fpts, tnorm_fpts=tnorm_fpts,
        fpt_face=fpt_face, opp_0=opp_0, opp_1=opp_1, opp_2=opp_2, opp_3=opp_3,
        loc_vol_cubpts=loc_cub, w_vol_cubpts=w_cub, opp_vol_cubpts=opp_cub,
        vandermonde=V, inv_vandermonde=Vinv, modal_norms=norms,
        opp_div_fused=opp_div_fused, upts_weights=w_upts)
