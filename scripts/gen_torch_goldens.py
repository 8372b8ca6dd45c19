#!/usr/bin/env python3
"""The f32 CPU golden residual rows of the PyTorch port's `quad`, `tet`,
`sem` and `advdiff` slices and of its forced channel `channel_bf1`
(chip_smoke.py), recorded with the JAX package.

  JAX_PLATFORMS=cpu python scripts/gen_torch_goldens.py [quad] [tet] [sem]
      [advdiff] [channel_bf1]

Protocol of bench.py (warmup + timed steps): 10 + 10 RK45 steps in f32, the
L1 residual row after step 20.
  quad: bench.mixed_input()'s deck (2-D viscous isentropic vortex, p=4,
        HLLC, dt 1e-4) on periodic_quad_mesh(96, 96, -10, 10, -10, 10):
        9,216 quads, 230,400 DOF;
  tet:  bench.run_tgv's TGV deck (p=4, HLLC) on periodic_tet_mesh(12, 12,
        12): 10,368 tets, 362,880 DOF;
  sem:  tests/test_turb_inlet.py's WALE LES deck with a 1000-eddy SEM inlet
        (mode 0) at p=4 on the 16^3 duct [-pi, pi]^3 (x- faces Inflow,
        x+ faces Outflow, y and z cyclic): 4,096 hexes, 512,000 points x 5
        fields; its fixed dt is compute_dt at the initial state with CFL
        0.5 (dt_type 1).  The JAX inlet's per-step draws (split the key
        into three, uniform (1000, 3) from the second and the third), taken
        again outside the solver from PRNGKey(0), go with dt into
        tests/data/torch_sem_draws.npz, which chip_smoke.py replays;
  advdiff: tests/test_adv_diff.py's deck (equation 1, LF, LDG beta 0.5,
        tau 1) with wave speed (1, 0.5, 0.25) at p=4 on the 16^3 box
        [-1, 1]^3: 512,000 points x 1 field, dt 1e-4 (the deck's 1e-3
        diverges at this resolution); also compute_error(2)'s solution
        and gradient rows (as `advdiff_error`) of the same run in f64: in
        f32 the state's rounding (6e-8 of the unit wave) outweighs the
        p=4 discretization error (the f32 rows read 2x and 3.4x the f64
        ones), so the error rows are held in f64;
  channel_bf1: bench.run_channel's deck (tests/decks/input_channel_les_bench,
        16^3 channel hexes, p=4) with body_force_type 1 (the deadbeat
        forcing, hifiles_tpu/solver/solver.py:513-516) set in code: the
        rows after 10 + 10 steps and after 100 steps (10-step chunks), then
        the same deck stepped one step at a time to step 100, logging the
        forcing's own |mflux / mdot0 - 1| after every step (its maximum as
        `channel_bf1_mflux_err`) and the step-100 row of that run.
Prints one JSON line per slice; paste the rows into chip_smoke.py's
TORCH_GOLDENS (and SEM_DT) with the date and this command.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# force the CPU backend the way tests/conftest.py does (an environment
# variable alone may come too late)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.extend.backend.clear_backends()
except Exception:
    pass
assert jax.default_backend() == "cpu", jax.default_backend()


def tgv_deck():
    """bench.run_tgv's deck (bench.py:278-298) at p=4."""
    import numpy as np
    from hifiles_tpu.config.params import RunInput
    p = RunInput()
    p.equation, p.viscous, p.order, p.ic_form = 0, 1, 4, 7
    p.adv_type, p.riemann_solve_type, p.dt_type, p.n_steps = 3, 3, 0, 20
    p.vcjh_scheme_hexa = 1
    p.dx_cyclic = p.dy_cyclic = p.dz_cyclic = 2 * np.pi
    p.gamma, p.R_gas, p.fix_vis = 1.4, 286.9, 1
    p.prandtl = 0.72
    p.Mach_free_stream, p.T_free_stream = 0.1, 300.0
    p.rho_free_stream = 0.0008421095852102401
    p.mu_gas = 1.827e-5
    p.L_free_stream = 1.0
    p.Mach_c_ic, p.T_c_ic, p.rho_c_ic = 0.1, 300.0, 0.0008421095852102401
    p.dt = 1.440389e-5
    p.setup_params()
    return p


def sem_case(n=16, order=4, n_eddy=1000):
    """tests/test_turb_inlet.py's deck on the n^3 duct (chip_smoke.duct_mesh
    and les_duct_input, built with the JAX package)."""
    import numpy as np
    from hifiles_tpu.mesh.generate import periodic_hex_mesh
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_turb_inlet import les_channel_input
    p = les_channel_input(inlet_type=2, n_eddy=n_eddy)
    inflow, outflow, cyc = p.bc_list
    p.bc_list = [cyc, inflow, outflow]
    p.order = order
    p.dy_cyclic = p.dz_cyclic = 2 * np.pi
    mesh = periodic_hex_mesh(n, n, n)
    for c in range(mesh.n_cells):
        if c % n == 0:
            mesh.bc_id[c, 4] = 1
        if c % n == n - 1:
            mesh.bc_id[c, 2] = 2
    mesh.bc_names = ["Cyclic", "Inflow", "Outflow"]
    return p, mesh


def sem_row(n_steps=20):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from hifiles_tpu.solver.solver import Solver

    p, mesh = sem_case()
    p.dt_type, p.CFL = 1, 0.5
    s = Solver(p, mesh, dtype=jnp.float32)
    dt = float(s.compute_dt())
    p.dt_type, p.dt = 0, dt
    key = s.turb_inlet.init_state[2]
    draws = []
    for _ in range(n_steps):
        key, k1, k2 = jax.random.split(key, 3)
        draws.append([np.asarray(jax.random.uniform(k, (1000, 3),
                                                    dtype=jnp.float32))
                      for k in (k1, k2)])
    out = os.path.join(ROOT, "tests", "data", "torch_sem_draws.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, draws=np.asarray(draws, dtype=np.float32),
                        dt=np.float64(dt))
    s.run(10, dt=dt)
    s.run(10, dt=dt)
    return {"sem": [float(x) for x in np.asarray(s.residual_norm(1))],
            "sem_dt": dt}


def advdiff_rows():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from hifiles_tpu.mesh.generate import periodic_hex_mesh
    from hifiles_tpu.solver.solver import Solver
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_adv_diff import adv_diff_input
    p = adv_diff_input(order=4)
    p.wave_speed, p.dz_cyclic, p.dt = (1.0, 0.5, 0.25), 2.0, 1e-4
    mesh = periodic_hex_mesh(16, 16, 16, -1, 1, -1, 1, -1, 1)
    s = Solver(p, mesh, dtype=jnp.float32)
    s.run(10, dt=p.dt)
    s.run(10, dt=p.dt)
    row = [float(x) for x in np.asarray(s.residual_norm(1))]
    jax.config.update("jax_enable_x64", True)
    try:
        s = Solver(p, mesh, dtype=jnp.float64)
        s.run(10, dt=p.dt)
        s.run(10, dt=p.dt)
        err = np.asarray(s.compute_error(2))
    finally:
        jax.config.update("jax_enable_x64", False)
    return {"advdiff": row,
            "advdiff_error": [float(err[0, 0]), float(err[1, 0])]}


def channel_bf1_rows(n_steps=100):
    import jax.numpy as jnp
    import numpy as np
    from hifiles_tpu.config.params import RunInput
    from hifiles_tpu.mesh.generate import channel_hex_mesh
    from hifiles_tpu.solver.solver import Solver

    def solver():
        p = RunInput.from_deck(os.path.join(ROOT, "tests", "decks",
                                            "input_channel_les_bench"))
        p.body_force_type = 1
        return Solver(p, channel_hex_mesh(16, 16, 16), dtype=jnp.float32), p

    row = lambda s: [float(x) for x in np.asarray(s.residual_norm(1))]
    s, p = solver()
    rows = {}
    for step in range(10, n_steps + 1, 10):
        s.run(10, dt=p.dt)
        if step in (20, n_steps):
            rows[step] = row(s)
    s, p = solver()
    errs = []
    for step in range(1, n_steps + 1):
        s.run(1, dt=p.dt)
        errs.append(abs(float(s._mdot_old) / p.body_force_mdot0 - 1.0))
        print(f"channel_bf1 step {step}: |mflux / mdot0 - 1| "
              f"{errs[-1]:.6e}", file=sys.stderr, flush=True)
    return {"channel_bf1": rows[20], "channel_bf1_100": rows[n_steps],
            "channel_bf1_mflux_err": max(errs),
            "channel_bf1_100_stepwise": row(s)}


def golden_row(name):
    import jax.numpy as jnp
    import numpy as np

    import bench
    from hifiles_tpu.mesh.generate import periodic_quad_mesh, periodic_tet_mesh
    from hifiles_tpu.solver.solver import Solver

    if name == "quad":
        p, mesh = bench.mixed_input(), periodic_quad_mesh(96, 96, -10, 10,
                                                          -10, 10)
    elif name == "tet":
        p, mesh = tgv_deck(), periodic_tet_mesh(12, 12, 12)
    else:
        raise SystemExit(f"unknown slice {name!r}: quad, tet, sem, "
                         "advdiff or channel_bf1")
    s = Solver(p, mesh, dtype=jnp.float32)
    s.run(10, dt=p.dt)
    s.run(10, dt=p.dt)
    return [float(x) for x in np.asarray(s.residual_norm(norm_type=1))]


if __name__ == "__main__":
    for name in sys.argv[1:] or ["quad", "tet", "sem", "advdiff",
                                 "channel_bf1"]:
        t0 = time.perf_counter()
        rows = {"sem": sem_row, "advdiff": advdiff_rows,
                "channel_bf1": channel_bf1_rows}.get(name)
        print(json.dumps(rows() if rows else {name: golden_row(name)}),
              flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
