"""1-D and tensor-product quadrature rules.

The reference loads Gauss / Gauss-Lobatto nodes from opaque binary tables
(ref:src/cubature_1d.cpp:50-84, data/JacobiG{Q,L}.bin).  We compute the same
rules from the standard recurrences instead; tests verify agreement with the
reference tables to machine precision.

Copied from hifiles_tpu/ops/quadrature.py (lines 1-90) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import numpy as np

#: upts_type / fpts_type codes (ref:src/input.cpp:270-297): 0=Gauss, 1=Gauss-Lobatto
GAUSS = 0
GAUSS_LOBATTO = 1


def gauss_legendre(n_pts: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes and weights on [-1, 1]."""
    x, w = np.polynomial.legendre.leggauss(n_pts)
    return x.astype(np.float64), w.astype(np.float64)


def gauss_lobatto(n_pts: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto-Legendre nodes and weights on [-1, 1].

    Interior nodes are the roots of P'_{n-1}, i.e. the Gauss-Jacobi(1,1)
    nodes; weights are 2 / (n (n-1) P_{n-1}(x)^2).
    """
    if n_pts < 2:
        raise ValueError("Gauss-Lobatto requires at least 2 points")
    n = n_pts
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        # roots of d/dx P_{n-1}
        cn = np.zeros(n)
        cn[n - 1] = 1.0
        dcoef = np.polynomial.legendre.legder(cn)
        interior = np.polynomial.legendre.legroots(dcoef)
        # Newton-polish the roots for full f64 accuracy
        for _ in range(3):
            d1 = np.polynomial.legendre.legval(interior, dcoef)
            d2 = np.polynomial.legendre.legval(
                interior, np.polynomial.legendre.legder(dcoef))
            interior = interior - d1 / d2
        x = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    pn = np.polynomial.legendre.legval(x, np.eye(n)[n - 1])
    w = 2.0 / (n * (n - 1) * pn**2)
    return x.astype(np.float64), w.astype(np.float64)


def line_rule(rule: int, order: int) -> tuple[np.ndarray, np.ndarray]:
    """1-D rule with ``order + 1`` points (ref:src/cubature_1d.cpp:48-56)."""
    n = order + 1
    if rule == GAUSS:
        return gauss_legendre(n)
    if rule == GAUSS_LOBATTO:
        return gauss_lobatto(n)
    raise ValueError(f"unknown 1-D quadrature rule {rule}")


def tensor_rule(rule: int, order: int, n_dims: int) -> tuple[np.ndarray, np.ndarray]:
    """Tensor-product rule over the reference quad/hex.

    Returns ``(locs, weights)`` with ``locs`` of shape ``(n_pts, n_dims)``;
    point ordering is x-fastest, matching the reference's tensor-product
    solution-point layout (ref:src/eles_quads.cpp:187-205).
    """
    x, w = line_rule(rule, order)
    n = order + 1
    if n_dims == 1:
        return x[:, None], w
    if n_dims == 2:
        X, Y = np.meshgrid(x, x, indexing="xy")  # upt = j + n*i -> (x_j, y_i)
        locs = np.stack([X.ravel(), Y.ravel()], axis=-1)
        W = np.outer(w, w).ravel()
        return locs, W
    if n_dims == 3:
        locs = np.empty((n**3, 3))
        W = np.empty(n**3)
        idx = 0
        for k in range(n):
            for i in range(n):
                for j in range(n):
                    locs[idx] = (x[j], x[i], x[k])
                    W[idx] = w[j] * w[i] * w[k]
                    idx += 1
        return locs, W
    raise ValueError(f"unsupported n_dims={n_dims}")
