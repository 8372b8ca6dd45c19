"""Shock capturing on the (U, F, E) state: the Persson modal sensor and the
exponential modal filter.

Port of hifiles_tpu/ops/stabilization.py::make_shock_capture_soa (:100-130);
the filter and sensor operators come from that module's numpy functions
(ref:src/eles_hexas.cpp:1007-1059 sensor, ref:src/eles_quads.cpp:790-820
filter, ref:src/eles.cpp:2918-2959 application once per RK stage).
"""

from __future__ import annotations

import torch

from hifiles_tpu.ops.stabilization import (build_exp_filter,
                                           persson_top_mode_mask)


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
