"""Dynamic viscosity and the advection-diffusion flux, copied from
hifiles_tpu/models/viscous.py:15-19 and :80-82.

Plain arithmetic: they take numpy arrays and torch tensors alike.  Unlike
solver/volume.py::sutherland_mu_p, which returns the float mu_inf when
fix_vis is set, sutherland_mu always returns an array shaped as ``inte``
(the forces index it per point).
"""

from __future__ import annotations


def sutherland_mu(inte, gamma, mu_inf, rt_inf, c_sth, fix_vis):
    """Dynamic viscosity (ref:src/flux.cpp:172-174); fix_vis=1 freezes mu."""
    rt_ratio = (gamma - 1.0) * inte / rt_inf
    mu = mu_inf * rt_ratio**1.5 * (1.0 + c_sth) / (rt_ratio + c_sth)
    return mu + fix_vis * (mu_inf - mu)


def adv_diff_viscous_flux(grad_u, diff_coeff):
    """Advection-diffusion 'viscous' flux (ref:src/flux.cpp:243-247)."""
    return -diff_coeff * grad_u
