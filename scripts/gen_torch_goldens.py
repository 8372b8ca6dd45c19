#!/usr/bin/env python3
"""The f32 CPU golden residual rows of the PyTorch port's `quad` and `tet`
slices (chip_smoke.py), recorded with the JAX package.

  JAX_PLATFORMS=cpu python scripts/gen_torch_goldens.py [quad] [tet]

Protocol of bench.py (warmup + timed steps): 10 + 10 RK45 steps in f32, the
L1 residual row after step 20.
  quad: bench.mixed_input()'s deck (2-D viscous isentropic vortex, p=4,
        HLLC, dt 1e-4) on periodic_quad_mesh(96, 96, -10, 10, -10, 10):
        9,216 quads, 230,400 DOF;
  tet:  bench.run_tgv's TGV deck (p=4, HLLC) on periodic_tet_mesh(12, 12,
        12): 10,368 tets, 362,880 DOF.
Prints one JSON line per slice; paste the rows into chip_smoke.py's
TORCH_GOLDENS with the date and this command.
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
        raise SystemExit(f"unknown slice {name!r}: quad or tet")
    s = Solver(p, mesh, dtype=jnp.float32)
    s.run(10, dt=p.dt)
    s.run(10, dt=p.dt)
    return [float(x) for x in np.asarray(s.residual_norm(norm_type=1))]


if __name__ == "__main__":
    for name in sys.argv[1:] or ["quad", "tet"]:
        t0 = time.perf_counter()
        row = golden_row(name)
        print(json.dumps({name: row}), flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
