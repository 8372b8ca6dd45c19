"""The reference's reading of a configuration's deck.

A configuration file holds its deck as key -> value strings, in the
reference solver's input format (``key value``, a vector as ``key N v1 ..
vN``).  ``physics`` turns the keys the benchmark's cases use into the
dimensionless numbers the solver steps with, by the HiFiLES reference's
rules (src/input.cpp:594-663): the free stream sets the reference density,
velocity, length and time; the viscosity, the time step and the initial
state are scaled by them.  Written for the reference from those rules; it
reads nothing of the program.
"""

from __future__ import annotations

import math


def scalar(deck: dict, key: str, default=None) -> float:
    """A deck value as a float (``default`` when the deck lacks it)."""
    if key not in deck:
        if default is None:
            raise KeyError(f"deck key {key!r} missing")
        return float(default)
    return float(str(deck[key]).split()[0])


def vector(deck: dict, key: str) -> list:
    """A ``N v1 .. vN`` deck value as a list of strings."""
    toks = str(deck.get(key, "0")).split()
    return toks[1:1 + int(toks[0])]


def physics(deck: dict) -> dict:
    """The dimensionless parameters of a viscous Navier-Stokes deck."""
    g = lambda k, d=None: scalar(deck, k, d)
    gamma, R = g("gamma", 1.4), g("R_gas", 286.9)
    T_ref, L_ref, rho_ref = (g("T_free_stream"), g("L_free_stream", 1.0),
                             g("rho_free_stream"))
    u_ref = g("Mach_free_stream") * math.sqrt(gamma * R * T_ref)
    p_ref = rho_ref * u_ref ** 2
    t_ref = L_ref / u_ref
    if int(g("fix_vis", 1)) != 1:
        raise NotImplementedError("the reference takes a constant viscosity")
    u_ic = g("Mach_c_ic") * math.sqrt(gamma * R * g("T_c_ic")) / u_ref
    les = int(g("LES", 0)) == 1
    if les and int(g("SGS_model")) != 0:
        raise NotImplementedError("the reference's SGS model is Smagorinsky")
    return dict(
        order=int(g("order")), gamma=gamma, prandtl=g("prandtl", 0.72),
        mu=g("mu_gas") / (rho_ref * u_ref * L_ref),
        R=R * T_ref / u_ref ** 2,
        dt=g("dt") / t_ref,
        ldg_beta=g("ldg_beta", 0.5), ldg_tau=g("ldg_tau", 0.0),
        # the initial state's constants
        rho_ic=g("rho_c_ic") / rho_ref,
        p_ic=g("rho_c_ic") * R * g("T_c_ic") / p_ref,
        T_ic=g("T_c_ic") / T_ref,
        vel_ic=[u_ic * g(k, d) for k, d in (("nx_c_ic", 1.0),
                                           ("ny_c_ic", 0.0),
                                           ("nz_c_ic", 0.0))],
        V0=u_ic,
        les=les, C_s=g("C_s", 0.1) if les else 0.0,
        filter_ratio=g("filter_ratio", 2.0) if les else 0.0,
        prandtl_t=g("prandtl_t", 0.9), kappa=g("Kappa", 0.41),
        forcing=int(g("body_forcing", 0)) == 1,
        bf_type=int(g("body_force_type", 0)),
        bf_area=g("body_force_area", 0.0), bf_mdot0=g("body_force_mdot0", 0.0),
        average_fields=vector(deck, "average_fields"),
        integrals=vector(deck, "integral_quantities"),
        spinup=g("spinup_time", 0.0),
    )
