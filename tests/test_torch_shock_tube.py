"""The Sod shock tube through the PyTorch port (hifiles_tpu_torch.Solver) on
the CPU in f64: the counterpart of tests/test_shock_tube.py (Persson sensor
+ exponential filter, HLLC, p=2, 120 x 2 quads, 1000 steps to t = 2 ms).
One run of each package; the port's state against the JAX state, and the
port's density against the exact Riemann solution with the JAX test's
bounds.  The run without shock capture (2500 steps) is left to the card
(chip_smoke.py's `long` phase)."""

import os
import sys

import numpy as np
import pytest
import torch

from hifiles_tpu.mesh.generate import channel_quad_mesh

import hifiles_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(__file__))
import chip_smoke  # noqa: E402
from test_shock_tube import _run_sod, exact_sod  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    """(the JAX solver, the port's solver, t) after one 1000-step run each
    of the Sod deck: the JAX test's own _run_sod, and chip_smoke.py's
    sod_input and sod_mesh on the port."""
    js, t = _run_sod(shock_cap=1)
    p = chip_smoke.sod_input()
    s = hifiles_tpu_torch.Solver(p, chip_smoke.sod_mesh(), device="cpu",
                                 dtype=torch.float64)
    s.run(1000, dt=p.dt)
    return js, s, t


def test_sod_state_matches_jax(runs):
    """After 1000 steps the port's state equals the JAX state within
    1e-10 * max|u|, on the same mesh."""
    js, s, t = runs
    jmesh = channel_quad_mesh(120, 2, 0.0, 10.0, 0.0, 0.2, bc_x="L",
                              bc_X="R")
    assert np.array_equal(chip_smoke.sod_mesh().bc_id, jmesh.bc_id)
    assert s.time == pytest.approx(js.time, rel=1e-15) and t == 1000 * 2e-6
    u_j, u_t = np.asarray(js.u), s.u
    assert u_t.shape == u_j.shape == (240, 9, 4)
    assert np.abs(u_t - u_j).max() <= 1e-10 * np.abs(u_j).max()


def test_sod_meets_exact_solution(runs):
    """The port's run meets tests/test_shock_tube.py's bounds: the L1
    distance of the cell-mean density to the exact solution < 0.02, cell
    means within (0.11, 1.05), nodal density within (0.115, 1.02); and
    chip_smoke.py's copies (exact_sod, sod_check) agree with the test's."""
    _, s, t = runs
    u = s.u
    assert np.isfinite(u).all()
    w = s.ops.upts_weights[None, :] * s.block.detjac_upts
    rho_mean = np.einsum("eu,eu->e", w, u[..., 0]) / w.sum(axis=1)
    x_mean = np.einsum("eu,eu->e", w, s.block.pos_upts[..., 0]) \
        / w.sum(axis=1)
    rho_exact = exact_sod(x_mean, t, 5.0, 1.0, 1e5, 0.125, 1e4)
    l1 = np.abs(rho_mean - rho_exact).mean()
    assert l1 < 0.02, l1
    assert rho_mean.max() < 1.05 and rho_mean.min() > 0.11
    assert u[..., 0].max() < 1.02 and u[..., 0].min() > 0.115
    assert np.array_equal(chip_smoke.exact_sod(x_mean, t, 5.0, 1.0, 1e5,
                                               0.125, 1e4), rho_exact)
    ok, l1_smoke, means, nodal = chip_smoke.sod_check(s, t)
    assert ok and l1_smoke == l1
    assert means == (rho_mean.min(), rho_mean.max())
    assert nodal == (u[..., 0].min(), u[..., 0].max())
