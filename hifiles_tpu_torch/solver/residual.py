"""Residual configuration and the element block's operators on the device.

Port of hifiles_tpu/solver/residual.py: ``ResidualConfig`` (:32-75) and the
operator part of ``BlockArrays`` (:76-140) that the SoA residual reads.  The
geometry planes are built by residual_soa.BlockArraysSoa straight from the
numpy block, in their compressed SoA layouts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .elements import ElementBlock


@dataclasses.dataclass(frozen=True)
class ResidualConfig:
    """Static numeric parameters of the residual: the fields of the JAX
    package's ``ResidualConfig`` that the port reads.  ``precision``
    (backend.select_device turns TF32 off instead) and ``fused`` (the port
    has no unfused parity path) have no counterpart."""
    equation: int = 0
    # advection-diffusion (equation 1, ref:src/flux.cpp:243-247) and its
    # Lax-Friedrichs flux (ref:src/inters.cpp:535-557)
    wave_speed: tuple = (0.0, 0.0, 0.0)
    lambda_lf: float = 1.0
    diff_coeff: float = 0.0
    viscous: bool = False
    riemann_solve_type: int = 0
    gamma: float = 1.4
    prandtl: float = 0.72
    prandtl_t: float = 0.9
    mu_inf: float = 0.0
    rt_inf: float = 1.0
    c_sth: float = 0.0
    fix_vis: int = 1
    ldg_tau: float = 0.0
    ldg_beta: float = 0.5
    rans: bool = False
    n_fields: int = 4
    over_int: bool = False
    # LES (ref:src/eles.cpp:2395-2646)
    les: bool = False
    sgs_model: int = 0
    C_s: float = 0.0
    filter_ratio: float = 2.0
    filter_type: int = 2
    kappa: float = 0.41
    # SA constants (ref:src/input.cpp:669-681)
    c_v1: float = 7.1
    c_v2: float = 0.7
    c_v3: float = 0.9
    c_b1: float = 0.1355
    c_b2: float = 0.622
    c_w2: float = 0.3
    c_w3: float = 2.0
    omega: float = 2.0 / 3.0


class BlockArrays:
    """ElementBlock operators as tensors on ``device`` in ``dtype``."""

    def __init__(self, block: ElementBlock, device, dtype):
        ops = block.ops
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=device)
        self.n_eles = block.n_eles
        self.n_upts = ops.n_upts
        self.n_fpts = ops.n_fpts
        self.n_dims = ops.n_dims
        self.opp_0 = f(ops.opp_0)                              # (Pf, U)
        self.opp_2_stack = f(np.stack([ops.opp_2[g]
                                       for g in range(ops.n_dims)]))
        self.opp_5_stack = f(np.stack(                         # (d, U, Pf)
            [ops.opp_3 * ops.tnorm_fpts[None, :, g]
             for g in range(ops.n_dims)]))
        self.opp_3 = f(ops.opp_3)                              # (U, Pf)
        self.opp_div_fused = f(ops.opp_div_fused)              # (U, d*U)
