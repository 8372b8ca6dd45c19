"""Shock capturing on the (U, F, E) state: the Persson modal sensor and the
exponential modal filter; and the over-integration (de-aliasing) operators.

The numpy builders build_exp_filter, _mode_degrees, persson_top_mode_mask
and build_over_int_ops are copied from hifiles_tpu/ops/stabilization.py
(:20-45, :48-61, :64-71, :133-180) unchanged, for every element type.
make_shock_capture_soa ports that module's make_shock_capture_soa
(:100-130) to torch (ref:src/eles_hexas.cpp:1007-1059 sensor,
ref:src/eles_quads.cpp:790-820 filter, ref:src/eles.cpp:2918-2959
application once per RK stage).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import HEX, PRISM, QUAD, TET, TRI
from .basis import tensor_legendre_modes
from .operators import ElementOps


def build_exp_filter(ops: ElementOps, expf_fac: float, expf_order: int,
                     expf_cutoff: int) -> np.ndarray:
    """Nodal exponential filter matrix V diag(sigma) V^-1."""
    order = ops.order
    eta_c = expf_cutoff / order
    sigma = np.ones(ops.n_upts)
    if ops.ele_type in (QUAD, HEX):
        modes = tensor_legendre_modes(order, ops.n_dims)
        # per-axis decay product (ref:src/eles_quads.cpp:799-816)
        for ax in range(ops.n_dims):
            eta = modes[:, ax] / order
            mask = eta > eta_c
            sigma[mask] *= np.exp(-expf_fac
                                  * ((eta[mask] - eta_c) / (1 - eta_c))
                                  ** expf_order)
    elif ops.ele_type in (TRI, TET, PRISM):
        # decay by total mode degree (ref:src/eles_tris.cpp:444-462; tets
        # and prisms follow the same Dubiner-degree rule)
        deg = _mode_degrees(ops)
        eta = deg / order
        mask = eta > eta_c
        sigma[mask] = np.exp(-expf_fac * ((eta[mask] - eta_c) / (1 - eta_c))
                             ** expf_order)
    else:
        raise NotImplementedError(f"exp filter for ctype {ops.ele_type}")
    return ops.vandermonde @ (sigma[:, None] * ops.inv_vandermonde)


def _mode_degrees(ops: ElementOps) -> np.ndarray:
    """Total polynomial degree of each modal basis function."""
    from .simplex import tet_modes, tri_modes
    order = ops.order
    if ops.ele_type == TRI:
        return np.array([i + j for (i, j) in tri_modes(order)])
    if ops.ele_type == TET:
        return np.array([i + j + k for (i, j, k) in tet_modes(order)])
    if ops.ele_type == PRISM:
        # hybrid basis: tri Dubiner x 1-D Legendre, z mode outer
        tri_deg = np.array([i + j for (i, j) in tri_modes(order)])
        n_tri = tri_deg.size
        return np.concatenate([tri_deg + kz for kz in range(order + 1)])
    raise NotImplementedError(f"mode degrees for ctype {ops.ele_type}")


def persson_top_mode_mask(ops: ElementOps) -> np.ndarray:
    """Modes counted as 'highest order' by the Persson sensor."""
    order = ops.order
    if ops.ele_type in (QUAD, HEX):
        modes = tensor_legendre_modes(order, ops.n_dims)
        return (modes == order).any(axis=1)
    # simplex/hybrid: top total degree (ref:src/eles_tris.cpp:475)
    return _mode_degrees(ops) >= order


def build_over_int_ops(ops: ElementOps, over_int_order: int):
    """Over-integration (de-aliasing) operators.

    Returns (loc_over_cubpts (C,d), opp_over (C,U) interpolation,
    over_filter (U,C) L2 projection back through the modal basis)
    (ref:src/eles_quads.cpp:928-959)."""
    from .quadrature import GAUSS, tensor_rule

    if ops.ele_type in (QUAD, HEX):
        loc, w = tensor_rule(GAUSS, over_int_order, ops.n_dims)
        from .basis import vandermonde_tensor
        phi = vandermonde_tensor(loc, ops.order)         # (C, n_modes)
        norms = ops.modal_norms
    elif ops.ele_type == TRI:
        from .simplex import dubiner_2d, tri_interior_cubature
        loc, w = tri_interior_cubature(min(over_int_order, 7))
        phi = dubiner_2d(loc, ops.order)
        norms = np.ones(ops.n_upts)
    elif ops.ele_type == TET:
        from .simplex import dubiner_3d, tet_interior_cubature
        loc, w = tet_interior_cubature(min(over_int_order, 6))
        phi = dubiner_3d(loc, ops.order)
        norms = np.ones(ops.n_upts)
    elif ops.ele_type == PRISM:
        # hybrid rule: tri interior cubature x 1-D Gauss; modal basis =
        # orthonormal tri Dubiner x unnormalized Legendre in z (norm
        # 2/(2k+1)), z mode outer — the layout of ops.vandermonde
        # (ref:src/eles_pris.cpp:938-969 set_over_int)
        from .basis import legendre
        from .quadrature import GAUSS, line_rule
        from .simplex import dubiner_2d, tri_interior_cubature
        tri_c, w_tc = tri_interior_cubature(min(over_int_order, 7))
        zc, wzc = line_rule(GAUSS, over_int_order)
        loc = np.array([(r, s, z) for z in zc for (r, s) in tri_c])
        w = np.array([wt * wz for wz in wzc for wt in w_tc])
        dub = dubiner_2d(loc[:, :2], ops.order)          # (C, n_tri)
        phi = np.concatenate(
            [dub * legendre(loc[:, 2], k)[:, None]
             for k in range(ops.order + 1)], axis=1)     # (C, U)
        norms = ops.modal_norms
    else:
        raise NotImplementedError(
            f"over-integration for ctype {ops.ele_type}")
    opp_over = ops.interp_to(loc)                        # (C, U)
    # modal projection: m_hat = phi^T W / norms; nodal = V @ m_hat
    proj = (phi / norms[None, :]).T * w[None, :]         # (n_modes, C)
    over_filter = ops.vandermonde @ proj                 # (U, C)
    return loc, opp_over, over_filter


def make_shock_capture_soa(ops, s0: float, expf_fac: float, expf_order: int,
                           expf_cutoff: int, shock_det_field: int,
                           n_dims: int, device, dtype):
    """capture(u) with u (U, F, E): replaces, IN PLACE, the state of every
    element whose Persson sensor on density (shock_det_field 0) or total
    energy is >= s0 by its exponentially filtered state, and returns u."""
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Vinv = f(ops.inv_vandermonde)                                  # (M, U)
    filt = f(build_exp_filter(ops, expf_fac, expf_order, expf_cutoff))
    norms = f(ops.modal_norms)[:, None]
    top = f(persson_top_mode_mask(ops))[:, None]
    field = 0 if shock_det_field == 0 else n_dims + 1

    def capture(u):
        U = u.shape[0]
        modal = Vinv @ u[:, field]                                 # (M, E)
        e2 = modal * modal * norms
        sensor = (e2 * top).sum(0) / e2.sum(0)                     # (E,)
        filtered = (filt @ u.reshape(U, -1)).view(u.shape)
        # torch.where writes a new tensor, so u is not read while written
        return u.copy_(torch.where(sensor >= s0, filtered, u))

    return capture
