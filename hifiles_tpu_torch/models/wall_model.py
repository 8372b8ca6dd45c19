"""Wall models on planes (ref:src/wall_model_funcs.cpp:13-119
calc_wall_stress).

Port of hifiles_tpu/models/wall_model.py::wall_stress_flux (:19-74).
wall_model 1 is the Werner-Wengle power law; 2 is the compressible log law
with the Van Driest transformation (adiabatic, NASA-TM-112910), whose Newton
iteration is the JAX package's fixed 25 steps.

Returns the wall-normal flux planes [0, tau_w, -q_w + v_w . tau_w (, 0)]
that replace the boundary common viscous flux
(ref:src/bdy_inters.cpp:1095-1131).
"""

from __future__ import annotations

import torch

from ..solver.volume import sutherland_mu_p


def wall_stress_flux(u_wm, u_w, dist, norm, *, wall_model, gamma, prandtl,
                     prandtl_t, mu_inf, rt_inf, c_sth, fix_vis, kappa,
                     n_dims):
    """F planes of the wall flux from the input state ``u_wm`` (F planes)
    at distance ``dist`` (a plane) and the wall state ``u_w`` (F planes,
    the no-slip BC state); ``norm`` is d planes.  Planes broadcast against
    each other."""
    d = n_dims
    rho_wm, rho_w = u_wm[0], u_w[0]
    v_wm_full = [u_wm[1 + m] / rho_wm for m in range(d)]
    vw = [u_w[1 + m] / rho_w for m in range(d)]
    v_n = sum(v_wm_full[m] * norm[m] for m in range(d))
    v_wm = [v_wm_full[m] - norm[m] * v_n for m in range(d)]   # wall-parallel
    v_rel = [v_wm[m] - vw[m] for m in range(d)]
    v_rel_mag = torch.clamp(torch.sqrt(sum(v * v for v in v_rel)),
                            min=1e-30)

    ke_wm = 0.5 * sum(v * v for v in v_wm_full)
    ke_w = 0.5 * sum(v * v for v in vw)
    inte_wm = u_wm[d + 1] / rho_wm - ke_wm
    inte_w = u_w[d + 1] / rho_w - ke_w

    if wall_model == 1:     # Werner-Wengle (ref:wall_model_funcs.cpp:52-79)
        mu_wm = sutherland_mu_p(inte_wm, gamma, mu_inf, rt_inf, c_sth,
                                fix_vis)
        Rey_c = 11.81**2
        Rey = rho_wm * v_rel_mag * dist / mu_wm
        lam = Rey < Rey_c
        uplus = torch.where(lam, torch.sqrt(Rey), 8.3**0.875 * Rey**0.125)
        utau = v_rel_mag / torch.clamp(uplus, min=1e-30)
        tw_mag = rho_wm * utau * utau
        dq = (inte_w - inte_wm) * gamma * tw_mag
        qw = torch.where(
            lam, dq / (prandtl * v_rel_mag),
            dq / (prandtl_t * (v_rel_mag
                               + utau * 11.81 * (prandtl / prandtl_t - 1.0))))
    elif wall_model == 2:   # log law + Van Driest (ref::80-103)
        B = torch.sqrt(2.0 * gamma * inte_w / prandtl_t)
        C = 5.2
        ueq = B * torch.asin(torch.clamp(v_rel_mag / B, -1.0, 1.0))
        mu_w = sutherland_mu_p(inte_w, gamma, mu_inf, rt_inf, c_sth, fix_vis)
        utau = torch.ones_like(v_rel_mag)
        for _ in range(25):
            logterm = torch.log(rho_w * dist * utau / mu_w)
            utau = utau - (utau * (logterm / kappa + C) - ueq) \
                / ((logterm + 1.0) / kappa + C)
        tw_mag = rho_w * utau * utau
        qw = torch.zeros_like(tw_mag)
    else:
        raise ValueError(f"wall model {wall_model} not implemented")

    scale = tw_mag / v_rel_mag
    tw = [scale * v for v in v_rel]
    vw_tw = sum(vw[m] * tw[m] for m in range(d))
    zero = torch.zeros_like(tw_mag)
    return [zero] + tw + [vw_tw - qw] + [zero] * (len(u_wm) - d - 2)
