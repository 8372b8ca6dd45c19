"""Surface forces and coefficients (ref:src/eles.cpp:5704-5990
compute_wall_forces, ref:src/output.cpp:1915-2016 CalcForces).

Integrates pressure and viscous stress over wall boundary faces (slip,
isothermal, adiabatic) at the face flux points using their quadrature
weights and surface Jacobians.  Returns the total force vector, the
per-face-point cp distribution, and CL/CD normalized by q_inf * area_ref.

Copied from hifiles_tpu/io/forces.py (lines 1-135) unchanged but for this
paragraph: ``solver.gradient_fn`` is the port's Solver.gradient_fn and
``sutherland_mu`` the port's copy (models/viscous.py).
"""

from __future__ import annotations

import numpy as np

from ..config.params import ADIABAT_WALL, ISOTHERM_WALL, SLIP_WALL
from ..models.viscous import sutherland_mu

WALL_FLAGS = (SLIP_WALL, ISOTHERM_WALL, ADIABAT_WALL)


def compute_forces(solver) -> dict:
    p = solver.p
    nd = solver.n_dims
    block = solver.block
    if not p.bc_list:
        raise ValueError("no boundary groups; forces undefined")
    flags = {i: bc.flag for i, bc in enumerate(p.bc_list)}
    wall_faces = [f for f, bcid in enumerate(block.bdy_bcid)
                  if flags.get(int(bcid), -1) in WALL_FLAGS]
    if not wall_faces:
        return {"force": np.zeros(nd), "inv_force": np.zeros(nd),
                "vis_force": np.zeros(nd), "coeff": np.zeros(nd),
                "cp": np.zeros((0,)), "cp_pos": np.zeros((0, nd)),
                "cp_mask": np.zeros((0,))}

    slots = block.bdy_slot[wall_faces]            # (Fw, nfp)
    mask = (block.bdy_mask[wall_faces]
            if block.bdy_mask is not None else np.ones(slots.shape))
    u = np.asarray(solver.u, dtype=np.float64)
    E, U, F = u.shape

    # state at wall fpts
    disu_f = np.einsum("pu,euf->epf", solver.ops.opp_0, u).reshape(-1, F)
    u_w = disu_f[slots]
    norm = block.norm_fpts[slots]
    tdA = block.tdA_fpts[slots]
    fpt_in_ele = slots % solver.ops.n_fpts
    wq = solver.ops.fpt_weights[fpt_in_ele]
    dA = wq * tdA * mask                           # physical surface measure

    rho = u_w[..., 0]
    vel = u_w[..., 1:1 + nd] / rho[..., None]
    pres = (p.gamma - 1.0) * (u_w[..., nd + 1]
                              - 0.5 * rho * np.sum(vel**2, axis=-1))

    # the reference's normalization: every force entry carries
    # factor/area_ref with factor = 1/q_inf from the IC state, and the
    # pressure enters as gauge pressure p - p_inf
    # (ref:src/eles.cpp:5743,5811,5908: Finv = wgt*(p-p_c_ic)*n*detjac
    #  *factor/area_ref)
    ic_vel = np.array([getattr(p, "u_c_ic", 0.0) or 0.0,
                       getattr(p, "v_c_ic", 0.0) or 0.0,
                       getattr(p, "w_c_ic", 0.0) or 0.0])[:nd]
    rho_ic = getattr(p, "rho_c_ic", 1.0) or 1.0
    q_ic = 0.5 * rho_ic * np.sum(ic_vel**2)
    factor = 1.0 / q_ic if q_ic > 0 else 1.0
    area_ref = getattr(p, "area_ref", 1.0) or 1.0
    p_inf = getattr(p, "p_c_ic", 0.0) or 0.0

    # inviscid: gauge-pressure force (ref:src/eles.cpp:5797-5811)
    inv_force = np.einsum("fq,fqd,fq->d", pres - p_inf, norm, dA) \
        * factor / area_ref

    vis_force = np.zeros(nd)
    if p.viscous:
        # LDG-corrected physical gradient at upts — identical to the
        # grad_disu_upts the reference's force routine interpolates
        # (ref:src/eles.cpp:5824-5838)
        grad_u = np.asarray(solver.gradient_fn(solver.u), dtype=np.float64)
        grad_f = np.einsum("pu,eufd->epfd", solver.ops.opp_0,
                           grad_u).reshape(-1, F, nd)
        g = grad_f[slots]
        rho_d = g[..., 0, :]
        mom_d = g[..., 1:1 + nd, :]
        dvel = (mom_d - vel[..., :, None] * rho_d[..., None, :]) \
            / rho[..., None, None]
        inte = u_w[..., nd + 1] / rho - 0.5 * np.sum(vel**2, axis=-1)
        mu = np.asarray(sutherland_mu(inte, p.gamma, p.mu_inf, p.rt_inf,
                                      p.c_sth, p.fix_vis)) \
            if p.viscous and np.isfinite(p.mu_inf) else 0.0
        diag = np.trace(dvel, axis1=-2, axis2=-1) / 3.0
        tau = mu[..., None, None] * (dvel + np.swapaxes(dvel, -1, -2)
                                     - 2 * diag[..., None, None] * np.eye(nd))
        # viscous traction: -tau . n integrated (ref:src/eles.cpp:5860-5908)
        vis_force = -np.einsum("fqij,fqj,fq->i", tau, norm, dA) \
            * factor / area_ref

    force = inv_force + vis_force
    out = {"force": force, "inv_force": inv_force, "vis_force": vis_force,
           "raw_force": force / factor * area_ref}
    out["coeff"] = force
    # pressure-coefficient distribution at the wall flux points
    # (ref:src/output.cpp:1934-1990, cp = (p-p_c_ic)*factor
    #  ref:src/eles.cpp:5795)
    out["cp"] = (pres - p_inf) * factor
    out["cp_pos"] = solver.block.pos_fpts[slots]
    out["cp_mask"] = mask
    return out


def write_force_file(solver, directory: str, iteration: int) -> str:
    """Append the total force/coefficients to force.dat and dump the wall
    cp distribution to cp_%09d.dat (ref:src/output.cpp:1915-2016)."""
    import os
    fr = compute_forces(solver)
    path = os.path.join(directory, "force.dat")
    new = not os.path.exists(path)
    nd = solver.n_dims
    with open(path, "a") as f:
        if new:
            f.write("# iter " + " ".join(f"F{a}" for a in "xyz"[:nd])
                    + " " + " ".join(f"C{a}" for a in "xyz"[:nd]) + "\n")
        f.write(f"{iteration} "
                + " ".join(f"{x:.10e}" for x in fr["force"]) + " "
                + " ".join(f"{x:.10e}" for x in fr["coeff"]) + "\n")
    if "cp" in fr and fr["cp"].size:
        cp_path = os.path.join(directory, f"cp_{iteration:09d}.dat")
        pos = fr["cp_pos"].reshape(-1, nd)
        cp = fr["cp"].reshape(-1)
        m = fr["cp_mask"].reshape(-1) > 0
        with open(cp_path, "w") as f:
            f.write("# " + " ".join("xyz"[:nd]) + " cp\n")
            for row, c in zip(pos[m], cp[m]):
                f.write(" ".join(f"{x:.10e}" for x in row)
                        + f" {c:.10e}\n")
    return path
