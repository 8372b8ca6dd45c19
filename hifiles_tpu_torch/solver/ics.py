"""Initial conditions and analytic solutions, vectorized over points.

Copied from hifiles_tpu/solver/ics.py with only the imports rewired to the
port's own config/ copy: the port imports nothing of hifiles_tpu.

ic_form codes (ref:src/eles.cpp:261-489): 0 isentropic vortex, 1 uniform,
2/3 sine wave single/group, 4 sphere, 5 const, 6 polynomial, 7 Taylor-Green,
9 stationary shock, 10 shock tube.
test_case codes (ref:src/eles.cpp:5149-5248): 1 vortex, 2/3 sine, 4 sphere,
5 Couette.
"""

from __future__ import annotations

import numpy as np

PI = np.pi


def eval_isentropic_vortex(pos: np.ndarray, time: float, gamma: float):
    """ref:src/funcs.cpp:1724-1739.  pos (..., d) -> rho, vel (..., d), p."""
    eps = 5.0
    x = pos[..., 0] - time
    y = pos[..., 1] - time
    f = 1.0 - (x * x + y * y)
    rho = (1.0 - eps**2 * (gamma - 1.0) / (8.0 * gamma * PI**2)
           * np.exp(f)) ** (1.0 / (gamma - 1.0))
    vx = 1.0 - eps * y / (2.0 * PI) * np.exp(f / 2.0)
    vy = 1.0 + eps * x / (2.0 * PI) * np.exp(f / 2.0)
    p = rho**gamma
    vel = np.stack([vx, vy] + ([np.zeros_like(vx)] if pos.shape[-1] == 3
                               else []), axis=-1)
    return rho, vel, p


def eval_sine_wave_single(pos, wave_speed, diff_coeff, time, n_dims):
    """ref:src/funcs.cpp:1742-1766 -> rho, grad_rho."""
    rel = pos - np.asarray(wave_speed)[:n_dims] * time
    angle = np.sum(rel, axis=-1)
    decay = np.exp(-n_dims * diff_coeff * PI**2 * time)
    rho = decay * np.sin(PI * angle)
    grad = np.repeat((PI * decay * np.cos(PI * angle))[..., None], n_dims,
                     axis=-1)
    return rho, grad


def eval_sine_wave_group(pos, wave_speed, diff_coeff, time, n_dims):
    """ref:src/funcs.cpp:1769-1794."""
    rel = pos - np.asarray(wave_speed)[:n_dims] * time
    decay = np.exp(-n_dims * diff_coeff * PI**2 * time)
    s = np.sin(PI * rel)
    c = np.cos(PI * rel)
    rho = decay * np.prod(s, axis=-1)
    grad = np.empty_like(rel)
    for ax in range(n_dims):
        others = np.prod(np.delete(s, ax, axis=-1), axis=-1)
        grad[..., ax] = PI * decay * c[..., ax] * others
    return rho, grad


def eval_sphere_wave(pos, wave_speed, time):
    """ref:src/funcs.cpp:1797-1808."""
    rel = pos - np.asarray(wave_speed)[:pos.shape[-1]] * time
    return np.exp(-0.5 * np.sum(rel * rel, axis=-1))


def eval_couette_flow(pos, gamma, R_ref, u_wall, T_wall, p_bound, prandtl,
                      T_ref, n_dims):
    """Analytic compressible Couette solution (ref:src/funcs.cpp:1830-1922).

    -> sol (..., F), grad (..., F, d)."""
    y = pos[..., 1]
    cp = gamma * R_ref / (gamma - 1.0)
    T_fact = 1.0 / T_ref
    h = 1.0
    vx = u_wall * (y / h)
    ka = T_fact
    kb = 0.5 * (prandtl / cp) * u_wall**2 * T_fact
    ps = p_bound
    Ts = T_wall + (y / h) * ka + kb * (y / h) * (1.0 - y / h)
    rho = ps / (R_ref * Ts)
    mom_x = rho * vx
    ene = ps / (gamma - 1.0) + 0.5 * rho * vx * vx

    n_fields = n_dims + 2
    sol = np.zeros(pos.shape[:-1] + (n_fields,))
    sol[..., 0] = rho
    sol[..., 1] = mom_x
    sol[..., n_dims + 1] = ene

    grad = np.zeros(pos.shape[:-1] + (n_fields, n_dims))
    rho_dy = -(ps / R_ref) * (
        ka / h - kb * y / h**2 + (kb / h) * (1.0 - y / h)) / Ts**2
    grad[..., 0, 1] = rho_dy
    grad[..., 1, 1] = rho_dy * vx + rho * (u_wall / h)
    grad[..., n_dims + 1, 1] = 0.5 * rho_dy * vx**2 + mom_x * (u_wall / h)
    return sol, grad


def initial_condition(run_input, pos: np.ndarray, n_fields: int) -> np.ndarray:
    """Pointwise ICs (ref:src/eles.cpp:237-512). pos (..., d) -> u (..., F)."""
    p_in = run_input
    n_dims = pos.shape[-1]
    gamma = p_in.gamma
    u = np.zeros(pos.shape[:-1] + (n_fields,))

    def pack(rho, vel, p):
        u[..., 0] = rho
        for ax in range(n_dims):
            u[..., 1 + ax] = rho * vel[..., ax]
        u[..., n_dims + 1] = p / (gamma - 1.0) + 0.5 * rho * np.sum(
            vel[..., :n_dims]**2, axis=-1)
        if p_in.RANS:
            u[..., n_dims + 2] = p_in.mu_tilde_c_ic

    if p_in.ic_form == 0:
        rho, vel, p = eval_isentropic_vortex(pos, 0.0, gamma)
        pack(rho, vel[..., :n_dims], p)
    elif p_in.ic_form == 1:
        vel = np.broadcast_to(
            np.array([p_in.u_c_ic, p_in.v_c_ic, p_in.w_c_ic])[:n_dims],
            pos.shape).copy()
        pack(np.full(pos.shape[:-1], p_in.rho_c_ic), vel,
             np.full(pos.shape[:-1], p_in.p_c_ic))
    elif p_in.ic_form == 2:
        rho, _ = eval_sine_wave_single(pos, p_in.wave_speed, p_in.diff_coeff,
                                       0.0, n_dims)
        u[..., 0] = rho
    elif p_in.ic_form == 3:
        rho, _ = eval_sine_wave_group(pos, p_in.wave_speed, p_in.diff_coeff,
                                      0.0, n_dims)
        u[..., 0] = rho
    elif p_in.ic_form == 4:
        u[..., 0] = eval_sphere_wave(pos, p_in.wave_speed, 0.0)
    elif p_in.ic_form == 5:
        u[..., 0] = p_in.rho_c_ic
    elif p_in.ic_form == 6:
        # constant rho/p, polynomial velocity profile (the reference marks
        # this path deprecated but keeps it, ref:src/eles.cpp:337-348,
        # ref:src/funcs.cpp:1926-1965 eval_poly_ic; the periodic-hill hack
        # zeroing velocity below y=1 is reproduced)
        def poly(coeffs):
            c = np.zeros(13)
            c[:len(coeffs)] = coeffs
            v = (c[0] + c[1] * pos[..., 0] + c[2] * pos[..., 0]**2
                 + c[3] * pos[..., 0]**3 + c[4] * pos[..., 0]**4
                 + c[5] * pos[..., 1] + c[6] * pos[..., 1]**2
                 + c[7] * pos[..., 1]**3 + c[8] * pos[..., 1]**4)
            if n_dims == 3:
                v += (c[9] * pos[..., 2] + c[10] * pos[..., 2]**2
                      + c[11] * pos[..., 2]**3 + c[12] * pos[..., 2]**4)
            return v
        vel = np.zeros(pos.shape[:-1] + (n_dims,))
        vel[..., 0] = poly(p_in.x_coeffs)
        vel[..., 1] = poly(p_in.y_coeffs)
        if n_dims == 3:
            vel[..., 2] = poly(p_in.z_coeffs)
        vel[pos[..., 1] < 1.0] = 0.0
        rho = np.full(pos.shape[:-1], p_in.rho_c_ic)
        # note: the reference stores the polynomials as MOMENTA (ics(1..))
        u[..., 0] = rho
        u[..., 1:1 + n_dims] = vel
        u[..., n_dims + 1] = (p_in.p_c_ic / (gamma - 1.0)
                              + 0.5 * np.sum(vel**2, axis=-1) / rho)
    elif p_in.ic_form == 7:
        # Taylor-Green vortex (ref:src/eles.cpp:348-371)
        V0 = p_in.uvw_c_ic / p_in.uvw_ref
        x, y = pos[..., 0], pos[..., 1]
        if n_dims == 2:
            p = (p_in.p_c_ic + p_in.rho_c_ic * V0**2 / 4.0
                 * (np.cos(2 * x) + np.cos(2 * y)))
            rho = p / (p_in.R_ref * p_in.T_c_ic)
            u[..., 0] = rho
            u[..., 1] = rho * V0 * np.sin(x) * np.cos(y)
            u[..., 2] = -rho * V0 * np.cos(x) * np.sin(y)
            u[..., 3] = (p / (gamma - 1.0)
                         + 0.5 * (u[..., 1]**2 + u[..., 2]**2) / rho)
        else:
            z = pos[..., 2]
            p = (p_in.p_c_ic + p_in.rho_c_ic * V0**2 / 16.0
                 * (np.cos(2 * x) + np.cos(2 * y)) * (np.cos(2 * z) + 2.0))
            rho = p / (p_in.R_ref * p_in.T_c_ic)
            u[..., 0] = rho
            u[..., 1] = rho * V0 * np.sin(x) * np.cos(y) * np.cos(z)
            u[..., 2] = -rho * V0 * np.cos(x) * np.sin(y) * np.cos(z)
            u[..., 3] = 0.0
            u[..., 4] = (p / (gamma - 1.0)
                         + 0.5 * (u[..., 1]**2 + u[..., 2]**2) / rho)
    elif p_in.ic_form == 9:
        # stationary shock: supersonic state left of x_shock from SUP_IN/CHAR
        # bc, IC state right (ref:src/eles.cpp:372-431)
        from ..config.params import CHAR, SUP_IN
        bc = next((b for b in p_in.bc_list if b.flag in (SUP_IN, CHAR)), None)
        if bc is None:
            raise ValueError("ic_form=9 needs a sup_in or char boundary")
        left = pos[..., 0] <= p_in.x_shock_ic
        rho = np.where(left, bc.rho, p_in.rho_c_ic)
        vel = np.where(left[..., None],
                       np.asarray(bc.velocity)[:n_dims],
                       np.array([p_in.u_c_ic, p_in.v_c_ic,
                                 p_in.w_c_ic])[:n_dims])
        p = np.where(left, bc.p_static, p_in.p_c_ic)
        pack(rho, vel, p)
    elif p_in.ic_form == 10:
        # Sod shock tube (ref:src/eles.cpp:432-485)
        left = pos[..., 0] <= p_in.x_shock_ic
        if p_in.viscous:
            pl, rl = 1e5 / p_in.p_ref, 1.0 / p_in.rho_ref
            pr, rr = 1e4 / p_in.p_ref, 0.125 / p_in.rho_ref
        else:
            pl, rl, pr, rr = 1e5, 1.0, 1e4, 0.125
        rho = np.where(left, rl, rr)
        p = np.where(left, pl, pr)
        pack(rho, np.zeros_like(pos), p)
    else:
        raise ValueError(f"ic_form {p_in.ic_form} not implemented")

    # channel perturbation (ref:src/eles.cpp:492-504)
    if p_in.perturb_ic == 1 and n_dims == 3:
        alpha, L_x, L_y, L_z = 0.1, 2 * PI, PI, 2.0
        u[..., 3] += (alpha * np.exp(-((pos[..., 0] - L_x / 2) / L_x) ** 2)
                      * np.exp(-(pos[..., 1] / L_y) ** 2)
                      * np.cos(4 * PI * pos[..., 2] / L_z))
    return u


def apply_patch(run_input, pos: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Solution patch: overwrite a region of the state after IC/restart
    (ref:src/eles.cpp:537-652 set_patch).

    patch_type 0: an isentropically-consistent Taylor-type vortex of
    strength Mv with inner/outer radii ra/rb at (xc, yc); type 1: reset to
    the uniform IC for x >= patch_x."""
    p = run_input
    if not p.patch:
        return u
    nd = pos.shape[-1]
    gamma = p.gamma
    R = p.R_ref if p.viscous else p.R_gas
    u = np.array(u, dtype=np.float64)
    rho = u[..., 0]
    vx = u[..., 1] / rho
    vy = u[..., 2] / rho
    vz = u[..., 3] / rho if nd == 3 else np.zeros_like(vx)
    pr = (gamma - 1.0) * (u[..., nd + 1]
                          - 0.5 * rho * (vx**2 + vy**2 + vz**2))
    if p.patch_type == 0:
        dx = pos[..., 0] - p.xc
        dy = pos[..., 1] - p.yc
        r = np.sqrt(dx * dx + dy * dy)
        r_safe = np.maximum(r, 1e-300)
        ra, rb, Mv = p.ra, p.rb, p.Mv
        vm = Mv * np.sqrt(gamma * pr / rho)
        T0 = pr / (rho * R)
        # inner solid-body rotation (ref::585-594)
        c_in = (vm**2 / ra**2 * 0.5 * (ra**2 - r**2)
                + vm**2 * ra**2 / (ra**2 - rb**2)**2
                * (0.5 * (rb**2 - ra**2)
                   - 0.5 * rb**4 * (1 / rb**2 - 1 / ra**2)
                   - 2 * rb**2 * np.log(rb / ra)))
        T_in = T0 - (gamma - 1.0) / (R * gamma) * c_in
        s_in = vm * r_safe / ra
        # outer decaying swirl (ref::596-603)
        c_out = (vm**2 * ra**2 / (ra**2 - rb**2)**2
                 * (0.5 * (rb**2 - r_safe**2)
                    - 0.5 * rb**4 * (1 / rb**2 - 1 / r_safe**2)
                    - 2 * rb**2 * np.log(rb / r_safe)))
        T_out = T0 - (gamma - 1.0) / (R * gamma) * c_out
        s_out = vm * ra / (ra**2 - rb**2) * (r_safe - rb**2 / r_safe)
        inner = r <= ra
        inside = r <= rb
        sw = np.where(inner, s_in, s_out)
        temper = np.where(inner, T_in, T_out)
        vx_n = vx - dy / r_safe * sw
        vy_n = vy + dx / r_safe * sw
        rho_n = rho * (temper / T0) ** (1.0 / (gamma - 1.0))
        p_n = pr * (temper / T0) ** (gamma / (gamma - 1.0))
        rho = np.where(inside, rho_n, rho)
        vx = np.where(inside, vx_n, vx)
        vy = np.where(inside, vy_n, vy)
        pr = np.where(inside, p_n, pr)
    elif p.patch_type == 1:
        m = pos[..., 0] >= p.patch_x
        rho = np.where(m, p.rho_c_ic, rho)
        vx = np.where(m, p.u_c_ic, vx)
        vy = np.where(m, p.v_c_ic, vy)
        vz = np.where(m, p.w_c_ic, vz)
        pr = np.where(m, p.p_c_ic, pr)
    else:
        raise ValueError(f"patch_type {p.patch_type}")
    out = u.copy()
    out[..., 0] = rho
    out[..., 1] = rho * vx
    out[..., 2] = rho * vy
    if nd == 3:
        out[..., 3] = rho * vz
        out[..., 4] = pr / (gamma - 1.0) + 0.5 * rho * (vx**2 + vy**2
                                                        + vz**2)
    else:
        out[..., 3] = pr / (gamma - 1.0) + 0.5 * rho * (vx**2 + vy**2)
    return out


def analytic_solution(run_input, pos: np.ndarray, time: float,
                      n_fields: int):
    """Analytic state + gradient for the error harness
    (ref:src/eles.cpp:5138-5248). Returns (sol, grad) with grad possibly 0."""
    p_in = run_input
    n_dims = pos.shape[-1]
    sol = np.zeros(pos.shape[:-1] + (n_fields,))
    grad = np.zeros(pos.shape[:-1] + (n_fields, n_dims))
    tc = p_in.test_case
    if tc == 1:
        rho, vel, p = eval_isentropic_vortex(pos, time, p_in.gamma)
        sol[..., 0] = rho
        for ax in range(n_dims):
            sol[..., 1 + ax] = rho * vel[..., ax]
        sol[..., n_dims + 1] = (p / (p_in.gamma - 1.0)
                                + 0.5 * rho * np.sum(vel[..., :n_dims]**2,
                                                     axis=-1))
    elif tc == 2:
        dc = p_in.diff_coeff if p_in.viscous else 0.0
        rho, g = eval_sine_wave_single(pos, p_in.wave_speed, dc, time, n_dims)
        sol[..., 0] = rho
        grad[..., 0, :] = g
    elif tc == 3:
        dc = p_in.diff_coeff if p_in.viscous else 0.0
        rho, g = eval_sine_wave_group(pos, p_in.wave_speed, dc, time, n_dims)
        sol[..., 0] = rho
        grad[..., 0, :] = g
    elif tc == 4:
        sol[..., 0] = eval_sphere_wave(pos, p_in.wave_speed, time)
    elif tc == 5:
        from ..config.params import ISOTHERM_WALL
        u_wall, T_wall = 0.0, 0.0
        for b in p_in.bc_list:
            if b.flag == ISOTHERM_WALL:
                if b.velocity[0] != 0.0:
                    u_wall = b.velocity[0]
                else:
                    T_wall = b.T_static
        sol, grad = eval_couette_flow(pos, p_in.gamma, p_in.R_ref, u_wall,
                                      T_wall, p_in.p_c_ic, p_in.prandtl,
                                      p_in.T_ref, n_dims)
    else:
        raise ValueError(f"test_case {tc} has no analytic solution")
    return sol, grad
