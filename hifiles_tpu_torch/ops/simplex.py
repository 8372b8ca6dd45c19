"""Simplex (tri/tet) machinery: orthonormal Jacobi & Dubiner bases, point
tables, and the DG lift.

Math follows Hesthaven & Warburton; behavior matches the reference's
funcs.cpp (eval_jacobi :1230-1300, eval_dubiner_basis_2d :1318-1356 and
derivatives, rs_to_ab :1143, eval_div_dg_tri :962-1048).  Solution-point
tables are the alpha-optimized sets shipped as binary data by the reference,
extracted into data/simplex_points.npz and verified by tests.

Copied from hifiles_tpu/ops/simplex.py (lines 1-350) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "simplex_points.npz")


@functools.lru_cache(maxsize=1)
def _tables():
    return np.load(_DATA)


def tri_alpha_points(order: int) -> np.ndarray:
    """Alpha-optimized tri solution points (n_pts, 2) on the reference
    triangle with vertices (-1,-1), (1,-1), (-1,1)."""
    return _tables()[f"tri_alpha_{order}"].copy()


def tri_interior_cubature(order: int) -> tuple[np.ndarray, np.ndarray]:
    t = _tables()[f"tri_inter_{order}"]
    return t[:, :2].copy(), t[:, 2].copy()


def tet_alpha_points(order: int) -> np.ndarray:
    return _tables()[f"tet_alpha_{order}"].copy()


def tet_interior_cubature(order: int) -> tuple[np.ndarray, np.ndarray]:
    t = _tables()[f"tet_inter_{order}"]
    return t[:, :3].copy(), t[:, 3].copy()


# ----------------------------------------------------------------------
def jacobi(x: np.ndarray, alpha: int, beta: int, n: int) -> np.ndarray:
    """Orthonormal Jacobi polynomial P_n^{(a,b)} on [-1,1]
    (three-term recurrence; matches ref:src/funcs.cpp eval_jacobi)."""
    x = np.asarray(x, dtype=np.float64)
    g = math.gamma
    p0 = math.sqrt(2.0 ** (-alpha - beta - 1) * g(alpha + beta + 2)
                   / (g(alpha + 1) * g(beta + 1)))
    if n == 0:
        return np.full_like(x, p0)
    p1 = (0.5 * p0 * math.sqrt((alpha + beta + 3.0)
                               / ((alpha + 1) * (beta + 1)))
          * ((alpha + beta + 2) * x + (alpha - beta)))
    if n == 1:
        return p1
    aold = (2.0 / (2 + alpha + beta)
            * math.sqrt((alpha + 1.0) * (beta + 1.0) / (alpha + beta + 3.0)))
    pm1, pm0 = p0 * np.ones_like(x), p1
    for i in range(1, n):
        h1 = 2.0 * i + alpha + beta
        anew = (2.0 / (h1 + 2.0)
                * math.sqrt((i + 1) * (i + 1 + alpha + beta)
                            * (i + 1 + alpha) * (i + 1 + beta)
                            / ((h1 + 1) * (h1 + 3))))
        bnew = -(alpha**2 - beta**2) / (h1 * (h1 + 2.0))
        pnew = ((x - bnew) * pm0 - aold * pm1) / anew
        pm1, pm0 = pm0, pnew
        aold = anew
    return pm0


def grad_jacobi(x: np.ndarray, alpha: int, beta: int, n: int) -> np.ndarray:
    """d/dx of the orthonormal Jacobi polynomial
    (ref:src/funcs.cpp:1302-1316)."""
    if n == 0:
        return np.zeros_like(np.asarray(x, dtype=np.float64))
    return math.sqrt(n * (n + alpha + beta + 1.0)) * jacobi(
        x, alpha + 1, beta + 1, n - 1)


def rs_to_ab(r: np.ndarray, s: np.ndarray):
    """Collapsed coordinates (ref:src/funcs.cpp:1143-1160)."""
    r = np.asarray(r, dtype=np.float64)
    s = np.asarray(s, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(s != 1.0, 2.0 * (1.0 + r) / (1.0 - s) - 1.0, -1.0)
    return a, s


def tri_modes(order: int) -> list[tuple[int, int]]:
    """Dubiner mode enumeration: total degree k, inner j
    (ref:src/funcs.cpp:1334-1346)."""
    return [(k - j, j) for k in range(order + 1) for j in range(k + 1)]


def dubiner_2d(locs: np.ndarray, order: int) -> np.ndarray:
    """(n_pts, n_modes) orthonormal Dubiner basis on the reference tri."""
    locs = np.atleast_2d(locs)
    a, b = rs_to_ab(locs[:, 0], locs[:, 1])
    out = np.empty((locs.shape[0], (order + 1) * (order + 2) // 2))
    for m, (i, j) in enumerate(tri_modes(order)):
        out[:, m] = (math.sqrt(2.0) * jacobi(a, 0, 0, i)
                     * jacobi(b, 2 * i + 1, 0, j) * (1.0 - b) ** i)
    return out


def grad_dubiner_2d(locs: np.ndarray, order: int) -> np.ndarray:
    """(n_pts, n_modes, 2) d/dr and d/ds of the Dubiner basis
    (ref:src/funcs.cpp:1358-1459)."""
    locs = np.atleast_2d(locs)
    a, b = rs_to_ab(locs[:, 0], locs[:, 1])
    n_modes = (order + 1) * (order + 2) // 2
    out = np.empty((locs.shape[0], n_modes, 2))
    sq2 = math.sqrt(2.0)
    for m, (i, j) in enumerate(tri_modes(order)):
        dPa = grad_jacobi(a, 0, 0, i)
        Pb = jacobi(b, 2 * i + 1, 0, j)
        Pa = jacobi(a, 0, 0, i)
        dPb = grad_jacobi(b, 2 * i + 1, 0, j)
        if i == 0:
            out[:, m, 0] = 0.0
            out[:, m, 1] = sq2 * Pa * dPb
        else:
            fac = (1.0 - b) ** (i - 1)
            out[:, m, 0] = 2.0 * sq2 * dPa * Pb * fac
            out[:, m, 1] = sq2 * (dPa * Pb * fac * (1.0 + a)
                                  + Pa * (dPb * (1.0 - b) ** i
                                          - Pb * i * fac))
    return out


# ----------------------------------------------------------------------
def tri_dg_lift(loc_upts: np.ndarray, loc_1d_fpts: np.ndarray,
                order: int) -> np.ndarray:
    """DG lift operator opp_3 for triangles (U, 3*(order+1)).

    opp_3[:, face*n+i] = V phi  with  sigma_m = int_edge phi_m l_i ds —
    the modal edge-mass lift, using the Dubiner basis's orthonormality
    (ref:src/funcs.cpp:630-666 get_opp_3_tri with DG filter == identity,
    :962-1048 eval_div_dg_tri)."""
    from .basis import lagrange_matrix
    from .quadrature import gauss_legendre

    n = order + 1
    U = (order + 1) * (order + 2) // 2
    xi, w = gauss_legendre(max(order + order + 2, 11))
    # edge parametrizations on the reference tri (ref:src/funcs.cpp:1012-1029)
    sqrt8 = 2.0 * math.sqrt(2.0)
    edges = [
        (lambda t: (-1.0 + t, -np.ones_like(t)), 2.0),            # bottom
        (lambda t: (1.0 - 2.0 * t / sqrt8, -1.0 + 2.0 * t / sqrt8),
         sqrt8),                                                  # hypotenuse
        (lambda t: (-np.ones_like(t), 1.0 - t), 2.0),             # left
    ]
    L = lagrange_matrix(xi, loc_1d_fpts)     # (q, n): l_i at quad pts
    V_upts = dubiner_2d(loc_upts, order)     # (U, U)
    opp3 = np.empty((loc_upts.shape[0], 3 * n))
    for e, (param, length) in enumerate(edges):
        t = (xi + 1.0) / 2.0 * length
        r, s = param(t)
        phi = dubiner_2d(np.stack([r, s], axis=1), order)   # (q, U)
        # sigma (U_modes, n_fpts): int phi_m l_i ds
        sigma = np.einsum("q,qm,qi->mi", w * (length / 2.0), phi, L)
        opp3[:, e * n:(e + 1) * n] = V_upts @ sigma
    return opp3


def tri_fpts(loc_1d_fpts: np.ndarray, order: int):
    """Tri flux-point locations/normals (ref:src/eles_tris.cpp:192-247,
    :402-427). Face order: 0 bottom, 1 hypotenuse, 2 left."""
    n = order + 1
    pts, nrm, face = [], [], []
    s2 = 1.0 / math.sqrt(2.0)
    for i in range(3):
        for j in range(n):
            if i == 0:
                pts.append((loc_1d_fpts[j], -1.0))
                nrm.append((0.0, -1.0))
            elif i == 1:
                pts.append((loc_1d_fpts[order - j], loc_1d_fpts[j]))
                nrm.append((s2, s2))
            else:
                pts.append((-1.0, loc_1d_fpts[order - j]))
                nrm.append((-1.0, 0.0))
            face.append(i)
    return (np.array(pts), np.array(nrm), np.array(face, dtype=np.int64))


# ----------------------------------------------------------------------
# 3-D (tetrahedra)

def rst_to_abc(r, s, t):
    """Collapsed tet coordinates (ref:src/funcs.cpp:1195-1222)."""
    r = np.asarray(r, dtype=np.float64)
    s = np.asarray(s, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(s + t != 0.0, -2.0 * (1.0 + r) / (s + t) - 1.0, -1.0)
        b = np.where(t != 1.0, 2.0 * (1.0 + s) / (1.0 - t) - 1.0, -1.0)
    return a, b, t


def tet_modes(order: int) -> list[tuple[int, int, int]]:
    """3-D Dubiner mode enumeration (ref:src/funcs.cpp:1476-1496)."""
    out = []
    for m_ in range(order + 1):
        for n_ in range(m_ + 1):
            for k in range(n_ + 1):
                j = n_ - k
                i = m_ - j - k
                out.append((i, j, k))
    return out


def dubiner_3d(locs: np.ndarray, order: int) -> np.ndarray:
    """(n_pts, n_modes) orthonormal 3-D Dubiner basis
    (ref:src/funcs.cpp:1461-1505)."""
    locs = np.atleast_2d(locs)
    a, b, c = rst_to_abc(locs[:, 0], locs[:, 1], locs[:, 2])
    modes = tet_modes(order)
    out = np.empty((locs.shape[0], len(modes)))
    for m, (i, j, k) in enumerate(modes):
        out[:, m] = (2.0 * math.sqrt(2.0) * jacobi(a, 0, 0, i)
                     * jacobi(b, 2 * i + 1, 0, j) * (1.0 - b) ** i
                     * jacobi(c, 2 * i + 2 * j + 2, 0, k)
                     * (1.0 - c) ** (i + j))
    return out


def grad_dubiner_3d(locs: np.ndarray, order: int) -> np.ndarray:
    """(n_pts, n_modes, 3) gradients (ref:src/funcs.cpp:1509-1617)."""
    locs = np.atleast_2d(locs)
    a, b, c = rst_to_abc(locs[:, 0], locs[:, 1], locs[:, 2])
    modes = tet_modes(order)
    out = np.empty((locs.shape[0], len(modes), 3))
    for m, (i, j, k) in enumerate(modes):
        fa = jacobi(a, 0, 0, i)
        gb = jacobi(b, 2 * i + 1, 0, j)
        hc = jacobi(c, 2 * (i + j) + 2, 0, k)
        dfa = grad_jacobi(a, 0, 0, i)
        dgb = grad_jacobi(b, 2 * i + 1, 0, j)
        dhc = grad_jacobi(c, 2 * (i + j) + 2, 0, k)
        scale = 2.0 ** (2 * i + j + 1.5)

        dr = dfa * gb * hc
        if i > 0:
            dr = dr * (0.5 * (1.0 - b)) ** (i - 1)
        if i + j > 0:
            dr = dr * (0.5 * (1.0 - c)) ** (i + j - 1)
        out[:, m, 0] = dr * scale

        ds = 0.5 * (1.0 + a) * dr
        tmp = dgb * (0.5 * (1.0 - b)) ** i
        if i > 0:
            tmp = tmp + (-0.5 * i) * gb * (0.5 * (1.0 - b)) ** (i - 1)
        if i + j > 0:
            tmp = tmp * (0.5 * (1.0 - c)) ** (i + j - 1)
        tmp = fa * tmp * hc
        ds = ds + tmp
        out[:, m, 1] = ds * scale

        dt = 0.5 * (1.0 + a) * dr + 0.5 * (1.0 + b) * tmp
        tmp2 = dhc * (0.5 * (1.0 - c)) ** (i + j)
        if i + j > 0:
            tmp2 = tmp2 - 0.5 * (i + j) * hc * (0.5 * (1.0 - c)) ** (i + j - 1)
        tmp2 = fa * gb * tmp2 * (0.5 * (1.0 - b)) ** i
        dt = dt + tmp2
        out[:, m, 2] = dt * scale
    return out


def tet_fpts(order: int, fpts_type: int = 0):
    """Tet flux points: a tri point set mapped to the 4 faces
    (ref:src/eles_tets.cpp:238-286, :540-573).

    Face order: 0 oblique (x+y+z=-1... the plane r+s+t=-1), 1 x=-1, 2 y=-1,
    3 z=-1; reference-domain normals (1,1,1)/sqrt(3), (-1,0,0), (0,-1,0),
    (0,0,-1)."""
    if fpts_type == 0:
        tri = tri_interior_cubature(order)[0]
    else:
        tri = tri_alpha_points(order)
    nfp = tri.shape[0]
    n = order + 1
    # reversed-in-row index map (ref:src/eles_tets.cpp:256-258)
    rev = np.empty(nfp, dtype=np.int64)
    for j in range(n):
        for i in range(n - j):
            idx = j * n - (j - 1) * j // 2 + i
            rev[idx] = j * n - (j - 1) * j // 2 + (order - j - i)
    r, s = tri[:, 0], tri[:, 1]
    pts = np.empty((4 * nfp, 3))
    pts[0 * nfp:1 * nfp] = np.stack([r[rev], r, s], axis=1)
    pts[1 * nfp:2 * nfp] = np.stack([-np.ones(nfp), s, r], axis=1)
    pts[2 * nfp:3 * nfp] = np.stack([r, -np.ones(nfp), s], axis=1)
    pts[3 * nfp:4 * nfp] = np.stack([s, r, -np.ones(nfp)], axis=1)
    s3 = 1.0 / math.sqrt(3.0)
    normals = np.array([(s3, s3, s3), (-1, 0, 0), (0, -1, 0), (0, 0, -1)],
                       dtype=np.float64)
    nrm = np.repeat(normals, nfp, axis=0)
    face = np.repeat(np.arange(4), nfp)
    return pts, nrm, face


def tet_dg_lift(loc_upts: np.ndarray, tloc_fpts: np.ndarray,
                order: int) -> np.ndarray:
    """DG lift for tets (U, 4*nfp) via face-modal integrals
    (ref:src/eles_tets.cpp:1168-1303 get_opp_3_dg_tet/eval_div_dg_tet)."""
    U = loc_upts.shape[0]
    nfp = tloc_fpts.shape[0] // 4
    cub, w = tri_interior_cubature(7)
    rq, sq = cub[:, 0], cub[:, 1]
    V3_upts = dubiner_3d(loc_upts, order)            # (U, U)
    opp3 = np.empty((U, 4 * nfp))
    # face parametrization & jacobian (ref:src/eles_tets.cpp:1259-1290)
    for face in range(4):
        fpts = tloc_fpts[face * nfp:(face + 1) * nfp]
        # face-local coordinates of this face's fpts (ref::1224-1240)
        if face == 0:
            rf, sf = fpts[:, 0], fpts[:, 2]
            jac = math.sqrt(3.0)
            r, s, t = rq, -1.0 - sq - rq, sq
        elif face == 1:
            rf, sf = fpts[:, 2], fpts[:, 1]
            jac = 1.0
            r, s, t = -np.ones_like(rq), sq, rq
        elif face == 2:
            rf, sf = fpts[:, 0], fpts[:, 2]
            jac = 1.0
            r, s, t = rq, -np.ones_like(rq), sq
        else:
            rf, sf = fpts[:, 1], fpts[:, 0]
            jac = 1.0
            r, s, t = sq, rq, -np.ones_like(rq)
        # Lagrange-through-modal on the face: cardinal functions of this
        # face's fpt set evaluated at the quadrature points
        Vf = dubiner_2d(np.stack([rf, sf], axis=1), order)     # (nfp, nfp)
        Vq = dubiner_2d(cub, order)                            # (q, nfp)
        L = Vq @ np.linalg.inv(Vf)                             # (q, nfp)
        phi3 = dubiner_3d(np.stack([r, s, t], axis=1), order)  # (q, U)
        sigma = np.einsum("q,qm,qi->mi", w * jac, phi3, L)     # (U, nfp)
        opp3[:, face * nfp:(face + 1) * nfp] = V3_upts @ sigma
    return opp3
