"""Diagnostics of the PyTorch port (hifiles_tpu_torch) against the JAX
package at f64 on the CPU: the LDG-corrected gradient (Solver.gradient_fn
against make_gradient_fn), the Persson sensor (sensor_fn and MixedSolver's
sensor_fns), the analytic error with its gradient row, and the reference
binary's Couette goldens through the port."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.config.params import (ADIABAT_WALL, CYCLIC, ISOTHERM_WALL,
                                       SLIP_WALL, SLIP_WALL_DUAL, BCParams,
                                       RunInput)
from hifiles_tpu.mesh.generate import (periodic_hex_mesh,
                                       periodic_mixed_mesh_2d,
                                       periodic_tet_mesh,
                                       ywall_channel_quad_mesh)
from hifiles_tpu.solver.multiblock import MixedSolver as JaxMixedSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import (mesh_from, run_input_from,
                                       ufe_to_euf)
from hifiles_tpu_torch.solver.step import RK45_A, RK45_B

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import bench  # noqa: E402
from test_face_path import tgv_input  # noqa: E402
from test_regression_reference import (COUETTE_GRAD_GOLD,  # noqa: E402
                                       COUETTE_SOL_GOLD)
from test_torch_boundaries import DUCT, wall_bc  # noqa: E402
from test_torch_element_types import (_pair, _walled,  # noqa: E402
                                      quad_box, quad_duct_mesh, tri_box,
                                      vortex_deck)
from test_torch_features import deck  # noqa: E402

torch.set_num_threads(1)

DECKS = os.path.join(os.path.dirname(__file__), "decks")


def tgv(order=2):
    p = tgv_input()
    p.order = order
    return p


def walled(flag, wall_model=0, les=0, riemann=3):
    """The walled quad channel of tests/test_torch_element_types.py:
    296-303 with the wall ``flag``."""
    p = deck(order=2, ic_form=1, LES=les)
    p.riemann_solve_type = riemann
    p.wall_model = wall_model
    p, mesh, _ = _walled(p, wall_bc(flag, int(wall_model > 0)))
    p.dx_cyclic = 4.0
    return p, mesh


def duct(pair):
    p = deck(order=2, ic_form=1)
    p.bc_list = [BCParams(name="Cyclic", flag=CYCLIC), *DUCT[pair]]
    p.dy_cyclic = 2.0
    return p, quad_duct_mesh()


def couette():
    p = RunInput.from_deck(os.path.join(DECKS, "input_couette_50"))
    return p, ywall_channel_quad_mesh(4, 4, 0.0, 2.0, 0.0, 1.0,
                                      bc_ymin="Isotherm_Fix",
                                      bc_ymax="Isotherm_Mov")


# the gradient's cases: periodic hex, quad, tri and tet blocks, the walled
# quad channel with each wall flag of the 2-D boundary tests
# (tests/test_torch_element_types.py:296-303), a characteristic duct and
# the Couette channel (isothermal fixed and moving walls)
GRADIENT_CASES = {
    "hex": lambda: (tgv(), periodic_hex_mesh(4, 4, 4)),
    "quad": lambda: (vortex_deck(order=3), quad_box()),
    "tri": lambda: (vortex_deck(order=3), tri_box()),
    "tet": lambda: (tgv(), periodic_tet_mesh(2, 2, 2)),
    "wall_adiabat": lambda: walled(ADIABAT_WALL),
    "wall_isotherm": lambda: walled(ISOTHERM_WALL),
    "wall_slip": lambda: walled(SLIP_WALL),
    "wall_slip_dual_roem": lambda: walled(SLIP_WALL_DUAL, riemann=2),
    "wall_adiabat_wm2": lambda: walled(ADIABAT_WALL, wall_model=2),
    "wall_isotherm_wm2_les": lambda: walled(ISOTHERM_WALL, wall_model=2,
                                            les=1),
    "duct_sub_char": lambda: duct("sub_char"),
    "couette": couette,
}


def seeded(u, seed=0, amp=0.02):
    rng = np.random.default_rng(seed)
    return np.asarray(u) * (1.0 + amp * rng.random(np.asarray(u).shape))


@pytest.mark.parametrize("case", sorted(GRADIENT_CASES))
def test_gradient_matches_jax(case):
    p, mesh = GRADIENT_CASES[case]()
    js, ts = _pair(p, mesh)
    u = seeded(js.u)
    want = np.asarray(js.gradient_fn(jnp.asarray(u)))
    got = ts.gradient_fn(u)
    assert got.shape == want.shape == u.shape + (ts.n_dims,)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() < 1e-10 * max(scale, 1.0), \
        np.abs(got - want).max()


def test_gradient_is_the_residuals():
    """gradient_fn is the residual's own gradient stage
    (residual_soa.gradient, the stage the SA source reads), laid out as
    (E, U, F, d)."""
    p = deck(order=2, RANS=1, riemann_solve_type=0)
    s = hifiles_tpu_torch.Solver(run_input_from(p),
                                 mesh_from(periodic_hex_mesh(3, 3, 3)),
                                 device="cpu")
    u = s.u_soa.clone()
    gr = s.residual_soa.gradient(u)
    assert gr.shape == (3,) + tuple(u.shape)
    np.testing.assert_array_equal(
        s.gradient_fn(ufe_to_euf(u)), gr.permute(3, 1, 2, 0).numpy())


@pytest.mark.parametrize("ctype", ["hex", "quad", "tri"])
def test_sensor_matches_jax(ctype):
    """sensor_fn on the `shock` configuration (RoeM, shock capture, s0 0)
    and on quad and tri blocks; None without shock capture."""
    if ctype == "hex":
        p, mesh = tgv(), periodic_hex_mesh(4, 4, 4)
        bench.configure(p, "shock")
    else:
        p = vortex_deck(order=3, shock_cap=1, s0=0.0, riemann_solve_type=2)
        mesh = quad_box() if ctype == "quad" else tri_box()
    js, ts = _pair(p, mesh)
    u = seeded(js.u, amp=0.05)
    want = np.asarray(js.sensor_fn(jnp.asarray(u)))
    got = ts.sensor_fn(u)
    assert got.shape == want.shape == (mesh.n_cells,)
    assert np.abs(got - want).max() < 1e-10 * max(np.abs(want).max(), 1.0)
    p.shock_cap = 0
    assert hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                    device="cpu").sensor_fn is None


def test_mixed_sensor_fns_match_jax():
    p = vortex_deck(order=2, shock_cap=1, s0=0.0, riemann_solve_type=2)
    mesh = periodic_mixed_mesh_2d(4, 4, -10, 10, -10, 10)
    js = JaxMixedSolver(p, mesh)
    ts = hifiles_tpu_torch.MixedSolver(run_input_from(p), mesh_from(mesh),
                                       device="cpu")
    assert sorted(ts.sensor_fns) == sorted(js.sensor_fns) == ts.cts
    for i, ct in enumerate(ts.cts):
        u = seeded(js.u[i], seed=i, amp=0.05)
        want = np.asarray(js.sensor_fns[ct](jnp.asarray(u)))
        got = ts.sensor_fns[ct](u)
        assert got.shape == (u.shape[0],)
        assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()
    p.shock_cap = 0
    assert hifiles_tpu_torch.MixedSolver(run_input_from(p), mesh_from(mesh),
                                         device="cpu").sensor_fns is None


def sine(tc):
    """The viscous TGV deck with a sine-wave test case (field 0 of the
    gradient row)."""
    p = tgv()
    p.test_case = tc
    p.wave_speed, p.diff_coeff = (1.0, 0.5, 0.25), 0.1
    return p, periodic_hex_mesh(4, 4, 4)


ERROR_CASES = {"couette": couette, "sine_single": lambda: sine(2),
               "sine_group": lambda: sine(3)}


@pytest.mark.parametrize("norm_type", [1, 2])
@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_compute_error_with_gradient_row(case, norm_type):
    """compute_error after 2 steps, its gradient row from the current state
    and from another state (u_grad)."""
    p, mesh = ERROR_CASES[case]()
    js, ts = _pair(p, mesh)
    js.run(2, dt=p.dt)
    ts.run(2, dt=p.dt)
    ug = seeded(js.u, seed=7)
    for kw_j, kw_t in (({}, {}), (dict(u_grad=jnp.asarray(ug)),
                                  dict(u_grad=ug))):
        want = js.compute_error(norm_type, **kw_j)
        got = ts.compute_error(norm_type, **kw_t)
        assert np.all(want[1, :1] > 0)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_couette_goldens():
    """The reference binary's Couette error.dat rows (solution and
    gradient L2) through the port, replayed as
    tests/test_regression_reference.py:278-308 does: the gradient row of
    the last RK stage's input state."""
    p, mesh = couette()
    s = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                 device="cpu")
    s.run(p.n_steps - 1, dt=p.dt)
    u, r = s.u_soa.clone(), torch.zeros_like(s.u_soa)
    for a, b in zip(RK45_A, RK45_B):
        u_stage5_in = u.clone()
        r = a * r + p.dt * s._rhs(u, None)
        u = u + b * r
    s.set_state(ufe_to_euf(u), np.zeros(ufe_to_euf(u).shape), s.time)
    err = np.sqrt(s.compute_error(2, u_grad=ufe_to_euf(u_stage5_in)))
    for row, gold in ((err[0], COUETTE_SOL_GOLD), (err[1], COUETTE_GRAD_GOLD)):
        gold = np.asarray(gold)
        assert np.all(np.abs(row - gold) < 1e-6 * np.maximum(1.0,
                                                             np.abs(gold))), \
            (list(row), list(gold))
