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
    package's ``ResidualConfig`` that the ported slice reads, plus the
    feature flags it rejects (``over_int``, ``les``, ``rans``).  The JAX
    fields of the physics not ported yet (SGS, SA, advection-diffusion)
    come with that physics.  ``precision`` (backend.select_device turns
    TF32 off instead) and ``fused`` (the port has no unfused parity path)
    have no counterpart."""
    equation: int = 0
    viscous: bool = False
    riemann_solve_type: int = 0
    gamma: float = 1.4
    prandtl: float = 0.72
    mu_inf: float = 0.0
    rt_inf: float = 1.0
    c_sth: float = 0.0
    fix_vis: int = 1
    ldg_tau: float = 0.0
    ldg_beta: float = 0.5
    n_fields: int = 4
    over_int: bool = False
    les: bool = False
    rans: bool = False


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
