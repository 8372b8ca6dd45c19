"""The CFL wavespeed on planes.

Port of hifiles_tpu/models/euler.py::max_wavespeed (:53-57) and the
cons_to_prim/pressure it calls (:13-26): |v| + c from the conservative
state ``u``, a sequence of field planes (e.g. ``u.unbind(1)`` of a
(U, F, E) state).
"""

from __future__ import annotations

import torch


def max_wavespeed(u, gamma: float, n_dims: int):
    """|v| + c, the CFL wavespeed (ref:src/eles.cpp:1295,1333), one plane."""
    rho = u[0]
    mom = u[1:1 + n_dims]
    ke = 0.5 * sum(m * m for m in mom) / rho
    p = (gamma - 1.0) * (u[n_dims + 1] - ke)
    vel = [m / rho for m in mom]
    c = torch.sqrt(gamma * p / rho)
    return torch.sqrt(sum(v * v for v in vel)) + c
