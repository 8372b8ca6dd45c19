"""Polynomial bases: Lagrange, Legendre, and hierarchical tensor Legendre.

Vectorized numpy implementations of the basis evaluations the reference does
pointwise (ref:src/funcs.cpp:316-471).  All functions accept arrays of
evaluation points and return matrices, since the solver only ever needs the
*matrices* (Vandermonde, interpolation, differentiation operators).

Copied from hifiles_tpu/ops/basis.py (lines 1-145) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import numpy as np


def lagrange_matrix(pts_out: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Matrix L with ``L[i, m] = l_m(pts_out[i])``.

    ``l_m`` is the Lagrange cardinal polynomial on ``nodes``
    (ref:src/funcs.cpp:316-333).
    """
    pts_out = np.asarray(pts_out, dtype=np.float64).ravel()
    nodes = np.asarray(nodes, dtype=np.float64).ravel()
    n = nodes.size
    L = np.ones((pts_out.size, n))
    for m in range(n):
        for j in range(n):
            if j != m:
                L[:, m] *= (pts_out - nodes[j]) / (nodes[m] - nodes[j])
    return L


def dlagrange_matrix(pts_out: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Matrix D with ``D[i, m] = l'_m(pts_out[i])`` (ref:src/funcs.cpp:337-370)."""
    pts_out = np.asarray(pts_out, dtype=np.float64).ravel()
    nodes = np.asarray(nodes, dtype=np.float64).ravel()
    n = nodes.size
    D = np.zeros((pts_out.size, n))
    for m in range(n):
        denom = 1.0
        for j in range(n):
            if j != m:
                denom *= nodes[m] - nodes[j]
        for i in range(n):
            if i == m:
                continue
            num = np.ones_like(pts_out)
            for j in range(n):
                if j != m and j != i:
                    num *= pts_out - nodes[j]
            D[:, m] += num / denom
    return D


def legendre(x: np.ndarray, n: int) -> np.ndarray:
    """Legendre polynomial P_n(x) via the three-term recurrence
    (ref:src/funcs.cpp:420-438)."""
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.ones_like(x)
    if n == 1:
        return x.copy()
    pm2 = np.ones_like(x)
    pm1 = x.copy()
    for k in range(2, n + 1):
        p = ((2 * k - 1) * x * pm1 - (k - 1) * pm2) / k
        pm2, pm1 = pm1, p
    return pm1


def dlegendre(x: np.ndarray, n: int) -> np.ndarray:
    """d/dx P_n(x), with the endpoint limits handled exactly
    (ref:src/funcs.cpp:442-471)."""
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.zeros_like(x)
    out = np.empty_like(x)
    interior = np.abs(x) < 1.0
    xi = x[interior]
    out[interior] = n * (xi * legendre(xi, n) - legendre(xi, n - 1)) / (xi * xi - 1.0)
    out[x == 1.0] = 0.5 * n * (n + 1.0)
    out[x == -1.0] = (-1.0) ** (n - 1) * 0.5 * n * (n + 1.0)
    return out


def vandermonde_1d(nodes: np.ndarray) -> np.ndarray:
    """V[i, j] = P_j(nodes[i]) (ref:src/eles_quads.cpp:759-769)."""
    nodes = np.asarray(nodes, dtype=np.float64).ravel()
    n = nodes.size
    return np.stack([legendre(nodes, j) for j in range(n)], axis=1)


def tensor_legendre_modes(order: int, n_dims: int) -> np.ndarray:
    """Hierarchical mode ordering of the tensor Legendre basis.

    Modes are enumerated by total degree k = sum of per-axis degrees, then by
    the reference's inner loop order (ref:src/eles_quads.cpp:1116-1154 for 2-D;
    ref:src/eles_hexas.cpp analog for 3-D).  Returns an ``(n_modes, n_dims)``
    int array of per-axis degrees.
    """
    modes = []
    if n_dims == 2:
        for k in range(2 * order + 1):
            for j in range(k + 1):
                i = k - j
                if i <= order and j <= order:
                    modes.append((i, j))
    elif n_dims == 3:
        # ref:src/eles_hexas.cpp:899-935 (eval_legendre_basis_3D_hierarchical):
        # loop k over total degree, then m (z), then j (y), i = k - j - m.
        for k in range(3 * order + 1):
            for m_ in range(k + 1):
                for j in range(k - m_ + 1):
                    i = k - j - m_
                    if i <= order and j <= order and m_ <= order:
                        modes.append((i, j, m_))
    else:
        raise ValueError(f"unsupported n_dims={n_dims}")
    out = np.array(modes, dtype=np.int64)
    assert out.shape[0] == (order + 1) ** n_dims
    return out


def vandermonde_tensor(locs: np.ndarray, order: int) -> np.ndarray:
    """Hierarchical tensor-Legendre Vandermonde at points ``locs`` (n_pts, d).

    V[i, m] = prod_axis P_{modes[m, axis]}(locs[i, axis])
    (ref:src/eles_quads.cpp:772-788).
    """
    locs = np.asarray(locs, dtype=np.float64)
    n_dims = locs.shape[1]
    modes = tensor_legendre_modes(order, n_dims)
    V = np.ones((locs.shape[0], modes.shape[0]))
    # cache P_n along each axis
    P = [np.stack([legendre(locs[:, ax], n) for n in range(order + 1)], axis=1)
         for ax in range(n_dims)]
    for m, deg in enumerate(modes):
        for ax in range(n_dims):
            V[:, m] *= P[ax][:, deg[ax]]
    return V


def tensor_legendre_norms(order: int, n_dims: int) -> np.ndarray:
    """L2 norms (u_m, u_m) of each hierarchical tensor-Legendre mode
    (ref:src/eles_quads.cpp:822-834, used by the Persson sensor)."""
    modes = tensor_legendre_modes(order, n_dims)
    return np.prod(2.0 / (2.0 * modes + 1.0), axis=1)
