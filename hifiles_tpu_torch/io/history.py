"""Run monitoring: residual norms, integral diagnostics, history file
(ref:src/output.cpp:2166-2408 HistoryOutput/NormResidual,
ref:src/eles.cpp:5485-5627 CalcIntegralQuantities).

Copied from hifiles_tpu/io/history.py (lines 1-122) unchanged but for
this paragraph and one repair: the port imports nothing of hifiles_tpu,
the relative imports resolve to the port's io.vtu and io.forces, and
``integral_quantities`` returns at once when no quantity is asked, where
the JAX copy first reads a pressure from the state and so fails on every
monitored advection-diffusion deck (one scalar field).
"""

from __future__ import annotations

import time as _time

import numpy as np


def integral_quantities(solver, names: list[str]) -> dict[str, float]:
    """Volume integrals over the domain: kineticenergy, enstropy,
    pressuredilatation, straincolonproduct, devstraincolonproduct
    (ref:src/eles.cpp:5545-5616).  Integrated at solution points with the
    quadrature weights (the reference integrates at volume cubature
    points; identical for Gauss solution points)."""
    if not names:
        return {}
    if hasattr(solver, "cts"):      # MixedSolver: accumulate per block
        from ..io.vtu import _MixedBlockView
        out = {n: 0.0 for n in names}
        for idx, ct in enumerate(solver.cts):
            sub = integral_quantities(_MixedBlockView(solver, ct, idx),
                                      names)
            for n in names:
                out[n] += sub[n]
        return out
    p = solver.p
    nd = solver.n_dims
    u = np.asarray(solver.u, dtype=np.float64)
    w = solver.ops.upts_weights[None, :] * solver.block.detjac_upts

    rho = u[..., 0]
    vel = u[..., 1:1 + nd] / rho[..., None]
    E = u[..., nd + 1]
    pres = (p.gamma - 1.0) * (E - 0.5 * rho * np.sum(vel**2, axis=-1))

    need_grad = any(n != "kineticenergy" for n in names)
    if need_grad:
        U = solver.ops.n_upts
        tgrad = np.einsum("kgu,euf->ekfg",
                          solver.ops.opp_2_cat.reshape(U, nd, U), u)
        grad = np.einsum("euml,eufm->eufl", solver.block.jginv_upts, tgrad) \
            / solver.block.detjac_upts[..., None, None]
        dvel = (grad[..., 1:1 + nd, :]
                - vel[..., :, None] * grad[..., 0, None, :]) / rho[..., None, None]

    out = {}
    for name in names:
        if name == "kineticenergy":
            q = 0.5 * rho * np.sum(vel**2, axis=-1)
        elif name == "enstropy":
            if nd == 2:
                vort2 = (dvel[..., 1, 0] - dvel[..., 0, 1]) ** 2
            else:
                wx = dvel[..., 2, 1] - dvel[..., 1, 2]
                wy = dvel[..., 0, 2] - dvel[..., 2, 0]
                wz = dvel[..., 1, 0] - dvel[..., 0, 1]
                vort2 = wx**2 + wy**2 + wz**2
            q = 0.5 * rho * vort2
        elif name == "pressuredilatation":
            q = pres * np.trace(dvel, axis1=-2, axis2=-1)
        elif name in ("straincolonproduct", "devstraincolonproduct"):
            S = 0.5 * (dvel + np.swapaxes(dvel, -1, -2))
            if name == "devstraincolonproduct":
                diag = np.trace(S, axis1=-2, axis2=-1) / nd
                S = S - diag[..., None, None] * np.eye(nd)
            q = np.sum(S * S, axis=(-2, -1))
        else:
            raise ValueError(f"unknown integral quantity '{name}'")
        out[name] = float(np.einsum("eu,eu->", w, q))
    return out


class HistoryWriter:
    """Tecplot-format history file (ref:src/output.cpp:2250-2342)."""

    def __init__(self, path: str, solver):
        self.path = path
        self.solver = solver
        self.t0 = _time.time()
        nd = solver.n_dims
        self.with_force = bool(solver.p.calc_force) \
            and getattr(solver.p, "bc_list", None)
        force_cols = ([f"F{ax}" for ax in "xyz"[:nd]]
                      + [f"C{ax}" for ax in "xyz"[:nd]]) \
            if self.with_force else []
        names = (["iter", "res_rho"]
                 + [f"res_{i}" for i in range(1, solver.n_fields)]
                 + force_cols
                 + list(solver.p.integral_quantities)
                 + ["nd_time", "compute_minutes"])
        with open(path, "w") as f:
            f.write('VARIABLES = ' + ', '.join(f'"{n}"' for n in names)
                    + '\nZONE T="history"\n')

    def write(self, iteration: int) -> dict:
        s = self.solver
        res = s.residual_norm(s.p.res_norm_type)
        if not np.isfinite(res).all():
            raise FloatingPointError(
                f"NaN residual at iteration {iteration} "
                "(ref:src/output.cpp:2243-2245 aborts here)")
        ints = integral_quantities(s, s.p.integral_quantities)
        out = {"residual": res, **ints}
        force_vals = []
        if self.with_force:
            from .forces import compute_forces
            fr = compute_forces(s)
            # Fx/Fy(/Fz) columns are dimensional, C* columns the
            # q_inf*area_ref-normalized coefficients compute_forces already
            # built (re-dividing here would double-normalize)
            force_vals = list(fr["raw_force"]) + list(fr["coeff"])
            out["force"] = fr["raw_force"]
            out["coeff"] = fr["coeff"]
        row = ([iteration] + [np.log10(max(r, 1e-300)) for r in res]
               + force_vals + list(ints.values())
               + [s.time, (_time.time() - self.t0) / 60.0])
        with open(self.path, "a") as f:
            f.write(" ".join(f"{v:.10e}" if isinstance(v, float) else str(v)
                             for v in row) + "\n")
        return out
