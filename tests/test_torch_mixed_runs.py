"""MixedSolver runs of the PyTorch port (hifiles_tpu_torch) against the JAX
package's MixedSolver at f64 on the CPU: plain steps, the shock-capture
post-stage and the SVV pre-step per type, the featured loop (body forcing
over each type's -x cyclic slots, running averages, the BC ramp counter);
MixedSolver on a single-type mesh against the port's Solver; and the
reference binary's goldens of the tri+quad and prism over-integration
cases (tests/test_regression_reference.py) and of the wall-modelled
prism/tet channel (tests/test_mixed_wall_model.py)."""

import os
import sys

import numpy as np
import pytest
import torch

from hifiles_tpu.config.params import RunInput
from hifiles_tpu.mesh.generate import (channel_mixed_mesh_2d,
                                       channel_prism_tet_mesh,
                                       channel_quad_mesh,
                                       periodic_mixed_mesh_2d,
                                       periodic_prism_mesh,
                                       periodic_quad_mesh)

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from chip_smoke import last_stage_residual  # noqa: E402
from test_mixed import vortex_input  # noqa: E402
from test_mixed_featured import _ramped_channel_input  # noqa: E402
from test_mixed_wall_model import PRISM_TET_WM_GOLD  # noqa: E402
from test_regression_reference import (MIX2D_OVERINT_GOLD,  # noqa: E402
                                       PRISM_OVERINT_GOLD)
from test_torch_mixed import pair  # noqa: E402

torch.set_num_threads(1)

DECKS = os.path.join(os.path.dirname(__file__), "decks")


def small_box():
    return periodic_mixed_mesh_2d(4, 4, -10, 10, -10, 10)


def vortex(**attrs):
    p = vortex_input(order=2, viscous=1)
    for k, v in attrs.items():
        setattr(p, k, v)
    return p


def forced_wm_channel():
    """tests/test_mixed_featured.py:54-85: the wall-modelled prism/tet
    channel with body forcing and running averages."""
    p = RunInput.from_deck(os.path.join(DECKS, "input_prism_tet_wm_bench"))
    p.forcing, p.body_force_type = 1, 0
    p.body_force_area = 1.0
    p.body_force_mdot0 = 0.0
    p.average_fields = ["rho_average", "u_average", "w_average"]
    p.spinup_time = 0.0
    return p, channel_prism_tet_mesh(4, 2, 1, 1, x1=2.0, y1=1.0, z1=1.0)


def ramped_channel():
    """tests/test_mixed_featured.py:149-166's ramped characteristic inflow
    on the tri+quad channel."""
    return _ramped_channel_input(), channel_mixed_mesh_2d(4, 2, 0.0, 2.0,
                                                          0.0, 1.0)


RUNS = {
    "plain": (lambda: (vortex(), small_box()), 1e-4),
    # Rusanov, as tests/test_mixed_soa.py:118-136 runs it: on the
    # stationary vortex RoeM's |M|**h switch turns roundoff in the normal
    # velocity of the faces along its symmetry lines into 1e-8 (its
    # residual parity is held on perturbed states, test_torch_mixed.py)
    "shock_capture": (lambda: (vortex(shock_cap=1, s0=0.0), small_box()),
                      1e-4),
    "svv": (lambda: (vortex(LES=1, SGS_model=3, filter_ratio=2.0),
                     small_box()), 1e-4),
    "forced_wm_channel": (forced_wm_channel, None),
    "ramped_channel": (ramped_channel, 1e-4),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_mixed_solver_steps_match_jax(case):
    """3 steps from the same state: the per-type states, and the featured
    carry (averages, mass-flux memory, ramp counter) agree to 1e-10."""
    make, dt = RUNS[case]
    p, mesh = make()
    dt = p.dt if dt is None else dt
    js, ts = pair(p, mesh)
    js.run(3, dt=dt)
    ts.run(3, dt=dt)
    assert ts.time == pytest.approx(js.time, rel=1e-15)
    scale = max(max(np.abs(np.asarray(a)).max() for a in js.u), 1.0)
    for a, b in zip(js.u, ts.u):
        assert np.isfinite(b).all()
        assert np.abs(np.asarray(a) - b).max() < 1e-10 * scale, \
            np.abs(np.asarray(a) - b).max()
    if ts._avg:
        for a, b in zip(js.u_avg, ts.u_avg):
            assert np.abs(np.asarray(a) - b).max() < 1e-10 * scale
    if ts._forcing:
        assert abs(ts.mdot_old - float(js._mdot_old)) < 1e-10
        for x, y in zip(ts.inflow_massflux(), js.inflow_massflux()):
            assert abs(x - y) <= 1e-10 * max(abs(y), 1.0), (x, y)
    if ts._has_ramp:
        assert float(ts._k) == int(js._iter_k) == 4
    r_j, r_t = js.residual_norm(1), ts.residual_norm(1)
    assert np.all(np.abs(r_t - r_j) <= 1e-10 * np.abs(r_j).max())
    if case == "plain":
        e_j, e_t = js.compute_error(2), ts.compute_error(2)
        assert np.all(e_j[0] > 0)
        assert np.all(np.abs(e_t - e_j) <= 1e-10 * np.abs(e_j))
        m_j, m_t = js.total_mass_energy(), ts.total_mass_energy()
        assert np.all(np.abs(m_t - m_j) <= 1e-12 * np.abs(m_j))


QUAD_ONLY = {
    "vortex": lambda: (vortex(), periodic_quad_mesh(4, 4, -10, 10, -10, 10)),
    "ramped_channel": lambda: (_ramped_channel_input(),
                               channel_quad_mesh(4, 2, 0.0, 2.0, 0.0, 1.0)),
}


@pytest.mark.parametrize("case", sorted(QUAD_ONLY))
def test_mixed_solver_on_quad_mesh_matches_solver(case):
    """A single-type quad mesh through MixedSolver (one block, its elements
    in the mt.sels order) against the port's Solver on the same mesh, the
    degenerate mixed case (JAX test_mixed.test_mixed_matches_pure_quad_flow
    compares the two solvers' errors; here the states agree to 1e-11)."""
    p, mesh = QUAD_ONLY[case]()
    sm = hifiles_tpu_torch.MixedSolver(run_input_from(p), mesh_from(mesh),
                                       device="cpu")
    s1 = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    assert len(sm.cts) == 1 and sm._has_ramp == (case == "ramped_channel")
    sel = sm.mt.sels[sm.cts[0]]
    sm.run(4, dt=1e-4)
    s1.run(4, dt=1e-4)
    u1, um = s1.u, sm.u[0]
    scale = max(np.abs(u1).max(), 1.0)
    assert np.abs(um - u1[sel]).max() < 1e-11 * scale
    r1, rm = s1.residual_norm(1), sm.residual_norm(1)
    assert np.all(np.abs(rm - r1) <= 1e-11 * np.abs(r1).max())


GOLDENS = {
    # tests/test_regression_reference.py:384-413, 2e-3 * max(0.05, gold)
    "mix2d_overint": ("input_mix2d_overint_25",
                      lambda: periodic_mixed_mesh_2d(6, 6, -np.pi, np.pi,
                                                     -np.pi, np.pi), 25,
                      MIX2D_OVERINT_GOLD,
                      lambda g: 2e-3 * np.maximum(0.05, g)),
    # :339-353, 2e-4 * max(0.05, gold)
    "prism_overint": ("input_pri_overint_25",
                      lambda: periodic_prism_mesh(4, 4, 4), 25,
                      PRISM_OVERINT_GOLD,
                      lambda g: 2e-4 * np.maximum(0.05, g)),
    # tests/test_mixed_wall_model.py:99-130, the iter-100 row, 1e-5
    "prism_tet_wm": ("input_prism_tet_wm_25",
                     lambda: channel_prism_tet_mesh(4, 4, 2, 2, x1=2.0,
                                                    y1=1.0, z1=1.0), 100,
                     PRISM_TET_WM_GOLD, lambda g: np.full_like(g, 1e-5)),
}


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_reference_golden(case):
    """The L1 monitor row against the reference binary's, f64."""
    deck, mesh, n_steps, gold, tol = GOLDENS[case]
    p = RunInput.from_deck(os.path.join(DECKS, deck))
    s = hifiles_tpu_torch.MixedSolver(run_input_from(p), mesh_from(mesh()),
                                      device="cpu")
    res = s.residual_norm(1, last_stage_residual(s, n_steps, p.dt))
    gold = np.asarray(gold)
    assert np.all(np.abs(res - gold) < tol(gold)), \
        (case, list(res), list(gold))
