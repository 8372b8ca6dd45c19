"""Run monitoring: residual norms, integral diagnostics, history file
(ref:src/output.cpp:2166-2408 HistoryOutput/NormResidual,
ref:src/eles.cpp:5485-5627 CalcIntegralQuantities).

Copied from hifiles_tpu/io/history.py (lines 1-122) unchanged but for
this paragraph, the program's tracing spans, the integrals in torch on
the solver's device and one repair: the port imports nothing of
hifiles_tpu, the relative imports resolve to the port's io.vtu and
io.forces, and ``integral_quantities`` returns at once
when no quantity is asked, where the JAX copy first reads a pressure
from the state and so fails on every monitored advection-diffusion deck
(one scalar field).  A history row runs in the span ``monitor``, split
into monitor.residual (the residual and its float64 sums a field
issued on the device), monitor.to_host (the sums waited for and copied
to the host), monitor.norm (the norms of the sums), monitor.integrals
(the integral quantities issued on the device), monitor.to_host (the
integrals copied), monitor.forces (with forces) and monitor.write (the
line appended).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from .. import tracing


def integral_quantities(solver, names: list[str]) -> dict[str, float]:
    """Volume integrals over the domain: kineticenergy, enstropy,
    pressuredilatation, straincolonproduct, devstraincolonproduct
    (ref:src/eles.cpp:5545-5616).  Integrated at solution points with the
    quadrature weights (the reference integrates at volume cubature
    points; identical for Gauss solution points), in float64: on the
    solver's device for the port's single-block Solver, whose integrals
    alone cross to the host, on the host's CPU for the other solvers'
    numpy states."""
    if not names:
        return {}
    if hasattr(solver, "cts"):      # MixedSolver: accumulate per block
        from ..io.vtu import _MixedBlockView
        out = {n: 0.0 for n in names}
        for idx, ct in enumerate(solver.cts):
            with tracing.span("monitor.to_host"):
                view = _MixedBlockView(solver, ct, idx)
            sub = integral_quantities(view, names)
            for n in names:
                out[n] += sub[n]
        return out
    if getattr(solver, "u_soa", None) is not None:
        with tracing.span("monitor.integrals"):
            (v,) = solver._views(solver.u_soa)
            q = _integrals(solver, names, v.permute(2, 0, 1))
        with tracing.span("monitor.to_host"):
            return dict(zip(names, q.cpu().tolist()))
    with tracing.span("monitor.to_host"):
        u = torch.from_numpy(np.asarray(solver.u, dtype=np.float64))
    with tracing.span("monitor.integrals"):
        return dict(zip(names, _integrals(solver, names, u).tolist()))


# elements a pass of the integrals takes in float64: the passes' scratch
# stays far below the residual's own
CHUNK = 4096


def _integrals(solver, names, u):
    """integral_quantities of one block's (E, U, F) state tensor ``u``
    on its device, CHUNK elements at a time in float64: a tensor of one
    integral a name."""
    nd = solver.n_dims
    geo = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                    device=u.device)
    detj = np.asarray(solver.block.detjac_upts, dtype=np.float64)
    wts = geo(solver.ops.upts_weights)
    grad_ops = None
    if any(n != "kineticenergy" for n in names):
        U = solver.ops.n_upts
        grad_ops = (geo(solver.ops.opp_2_cat).reshape(U, nd, U),
                    np.asarray(solver.block.jginv_upts, dtype=np.float64))
    out = 0.0
    for e0 in range(0, u.shape[0], CHUNK):
        e = slice(e0, e0 + CHUNK)
        g = None if grad_ops is None else (grad_ops[0], geo(grad_ops[1][e]))
        out = out + _chunk_integrals(solver.p, nd, names,
                                     u[e].to(torch.float64), wts,
                                     geo(detj[e]), g)
    return out


def _chunk_integrals(p, nd, names, u, wts, detj, grad_ops):
    """The integrals of a chunk of elements: its (E, U, F) float64 state,
    the solution points' weights, the chunk's (E, U) Jacobian
    determinants and, for the quantities of the velocity gradient, the
    (U, nd, U) derivative operator and the chunk's (E, U, nd, nd)
    inverse Jacobians."""
    w = wts[None, :] * detj
    rho = u[..., 0]
    vel = u[..., 1:1 + nd] / rho[..., None]
    E = u[..., nd + 1]
    pres = (p.gamma - 1.0) * (E - 0.5 * rho * torch.sum(vel**2, dim=-1))

    if grad_ops is not None:
        opp, jginv = grad_ops
        tgrad = torch.einsum("kgu,euf->ekfg", opp, u)
        grad = torch.einsum("euml,eufm->eufl", jginv, tgrad) \
            / detj[..., None, None]
        dvel = (grad[..., 1:1 + nd, :]
                - vel[..., :, None] * grad[..., 0, None, :]) / rho[..., None, None]

    trace = lambda a: a.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    out = []
    for name in names:
        if name == "kineticenergy":
            q = 0.5 * rho * torch.sum(vel**2, dim=-1)
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
            q = pres * trace(dvel)
        elif name in ("straincolonproduct", "devstraincolonproduct"):
            S = 0.5 * (dvel + dvel.transpose(-1, -2))
            if name == "devstraincolonproduct":
                S = S - (trace(S) / nd)[..., None, None] * torch.eye(
                    nd, dtype=S.dtype, device=S.device)
            q = torch.sum(S * S, dim=(-2, -1))
        else:
            raise ValueError(f"unknown integral quantity '{name}'")
        out.append(torch.einsum("eu,eu->", w, q))
    return torch.stack(out)


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

    @tracing.traced("monitor")
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
            with tracing.span("monitor.forces"):
                fr = compute_forces(s)
            # Fx/Fy(/Fz) columns are dimensional, C* columns the
            # q_inf*area_ref-normalized coefficients compute_forces already
            # built (re-dividing here would double-normalize)
            force_vals = list(fr["raw_force"]) + list(fr["coeff"])
            out["force"] = fr["raw_force"]
            out["coeff"] = fr["coeff"]
        with tracing.span("monitor.write"):
            row = ([iteration] + [np.log10(max(r, 1e-300)) for r in res]
                   + force_vals + list(ints.values())
                   + [s.time, (_time.time() - self.t0) / 60.0])
            with open(self.path, "a") as f:
                f.write(" ".join(f"{v:.10e}" if isinstance(v, float)
                                 else str(v) for v in row) + "\n")
        return out
