"""LES solution-point filter matrices (ref per-type compute_filter_upts,
e.g. ref:src/eles_quads.cpp:428-630).

filter_type codes: 0 Vasilyev high-order commuting, 1 discrete Gaussian,
2 modal (Gaussian in modal space), else simple average.  Tensor elements
build a 1-D filter and take its tensor product; triangles filter in Dubiner
modal space.

Copied from hifiles_tpu/ops/les_filter.py (lines 1-103) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import numpy as np

from .. import HEX, QUAD, TRI
from .basis import vandermonde_1d
from .operators import ElementOps
from .quadrature import gauss_legendre


def _vasilyev_1d(x: np.ndarray, filter_ratio: float, order: int) -> np.ndarray:
    """High-order-commuting Vasilyev filter (ref:src/eles_quads.cpp:456-510).

    Row i solves: sum_j w_ij = 1; sum_j w_ij cos(pi k_c beta_ij) = Gauss
    weight; derivative constraint; higher moments zero."""
    N = x.size
    k_c = 1.0 / filter_ratio
    dlt = 2.0 / order
    beta = (x[:, None] - x[None, :]) / dlt      # beta(j,i) in ref = (x_j-x_i)
    N2 = N // 2 + (N % 2)
    W = np.empty((N, N))
    for i in range(N):
        B = np.zeros(N)
        A = np.zeros((N, N))
        B[0] = 1.0
        B[1] = np.exp(-np.pi**2 / 24.0)
        B[2] = -B[1] * np.pi**2 / k_c / 12.0
        mid = (N % 2 == 1 and i + 1 == N2)
        if mid:
            B[2] = 0.0
        for j in range(N):
            b = beta[j, i]
            A[j, 0] = 1.0
            A[j, 1] = np.cos(np.pi * k_c * b)
            A[j, 2] = -b * np.pi * np.sin(np.pi * k_c * b)
            if mid:
                A[j, 2] = b**3
            for k in range(3, N):
                A[j, k] = b ** (k + 1)
        # solve A^T? reference uses gaussj(N, A, B) solving A w = B with w
        # the row weights laid out along j
        W[:, i] = np.linalg.solve(A.T, B)
    # reference stores filter_upts_1D(j,i) = B(j) after solving for column i
    return W.T


def _gaussian_1d(x: np.ndarray, filter_ratio: float, order: int) -> np.ndarray:
    """Discrete Gaussian filter, no iterative constraining
    (ref:src/eles_quads.cpp:511-582, ctype=-1 branch)."""
    N = x.size
    k_c = 1.0 / filter_ratio
    dlt = 2.0 / order
    beta = (x[:, None] - x[None, :]) / dlt
    _, wf = gauss_legendre(N)
    W = wf[None, :] * np.exp(-6.0 * (k_c * beta) ** 2)
    return W / W.sum(axis=1, keepdims=True)


def _modal_1d(x: np.ndarray) -> np.ndarray:
    """Modal-space Gaussian filter (ref:src/funcs.cpp:669-716
    compute_modal_filter_1d)."""
    N = x.size
    V = vandermonde_1d(x)
    sigma = np.exp(-(2.0 * np.arange(N) / N) ** 2 / 48.0)
    return V @ (sigma[:, None] * np.linalg.inv(V))


def build_les_filter(ops: ElementOps, filter_type: int,
                     filter_ratio: float) -> np.ndarray:
    """(U, U) solution-point filter for one element type."""
    order = ops.order
    if ops.ele_type in (QUAD, HEX):
        x = ops.loc_upts[:order + 1, 0]
        if filter_type == 0 and order + 1 >= 3:
            f1 = _vasilyev_1d(x, filter_ratio, order)
        elif filter_type == 1:
            f1 = _gaussian_1d(x, filter_ratio, order)
        elif filter_type == 2:
            f1 = _modal_1d(x)
        else:
            f1 = np.full((order + 1, order + 1), 1.0 / (order + 1))
        # tensor product (ref:src/eles_quads.cpp:609-630)
        F = f1
        for _ in range(ops.n_dims - 1):
            F = np.kron(f1, F)
        return F
    if ops.vandermonde is not None:
        # modal Gaussian in the (Dubiner / hybrid) modal space — the same
        # SD3D form the reference uses for tris and tets
        # (ref:src/eles_tris.cpp:786+, ref:src/eles_tets.cpp:666-700)
        N = ops.n_upts
        sigma = np.exp(-(2.0 * np.arange(N) / N) ** 2 / 48.0)
        return ops.vandermonde @ (sigma[:, None] * ops.inv_vandermonde)
    raise NotImplementedError(f"LES filter for ctype {ops.ele_type}")
