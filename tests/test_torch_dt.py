"""CFL time steps in the PyTorch port (hifiles_tpu_torch): compute_dt for
dt_type 1 (global) and 2 (per element) against the JAX package's
Solver.compute_dt and MixedSolver.compute_dt, and runs that step with them
against the JAX run, at f64 on the CPU from the same seeded states."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.mesh.generate import (periodic_hex_mesh,
                                       periodic_mixed_mesh_2d,
                                       periodic_quad_mesh, periodic_tet_mesh)
from hifiles_tpu.solver.multiblock import MixedSolver as JaxMixedSolver
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from

sys.path.insert(0, os.path.dirname(__file__))
from test_face_path import tgv_input  # noqa: E402
from test_mixed import vortex_input  # noqa: E402
from test_torch_featured import channel_twin  # noqa: E402

torch.set_num_threads(1)


def tgv(order=2, **attrs):
    p = tgv_input()
    p.order = order
    for k, v in attrs.items():
        setattr(p, k, v)
    return p


def vortex(viscous):
    p = vortex_input(order=2, viscous=viscous)
    return p


# name -> (deck, mesh): viscous and inviscid, constant and Sutherland mu,
# on hexes, quads and tets
CASES = {
    "hex_viscous": lambda: (tgv(order=3), periodic_hex_mesh(4, 4, 4)),
    "hex_sutherland": lambda: (tgv(fix_vis=0), periodic_hex_mesh(4, 4, 4)),
    "hex_inviscid": lambda: (tgv(viscous=0), periodic_hex_mesh(4, 4, 4)),
    "quad_viscous": lambda: (vortex(1), periodic_quad_mesh(6, 6, -10, 10,
                                                           -10, 10)),
    "quad_inviscid": lambda: (vortex(0), periodic_quad_mesh(6, 6, -10, 10,
                                                            -10, 10)),
    "tet_viscous": lambda: (tgv(), periodic_tet_mesh(2, 2, 2)),
}


def seeded(u, seed=0, amp=0.02):
    """(E, U, F) state times (1 + amp * uniform) from a seed."""
    rng = np.random.default_rng(seed)
    return np.asarray(u) * (1.0 + amp * rng.random(np.asarray(u).shape))


def pair(p, mesh, dt_type, CFL=0.4):
    """The JAX Solver and the port's CPU Solver of one deck with dt_type
    and CFL set, holding the same seeded state."""
    p.dt_type, p.CFL = dt_type, CFL
    js = JaxSolver(p, mesh)
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    u0 = seeded(js.u)
    js.u = jnp.asarray(u0)
    ts.set_state(u0, np.zeros_like(u0), 0.0)
    return js, ts


@pytest.mark.parametrize("dt_type", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_dt_matches_jax(case, dt_type):
    p, mesh = CASES[case]()
    js, ts = pair(p, mesh, dt_type)
    want = np.asarray(js.compute_dt())
    got = ts.compute_dt()
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert got.shape == ((mesh.n_cells,) if dt_type == 2 else ())
    got = got.numpy()
    assert np.all(want > 0)
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want)), \
        np.abs(got / want - 1).max()


def test_viscous_limit_binds():
    """At a large viscosity the viscous limit max(4/3, gamma/Pr) mu/rho is
    the smaller one on every element, and the port takes it as the JAX
    rule does."""
    from hifiles_tpu.models.euler import max_wavespeed
    p = tgv(mu_inf=4.0)
    js, ts = pair(p, periodic_hex_mesh(4, 4, 4), 2)
    lam = np.asarray(max_wavespeed(js.u, p.gamma, 3)).max(axis=1)
    inviscid = p.CFL * js.block.h_ref / lam / (2 * p.order + 1)
    got = ts.compute_dt().numpy()
    assert np.all(got < 0.9 * inviscid)
    np.testing.assert_allclose(got, np.asarray(js.compute_dt()),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("dt_type", [1, 2])
@pytest.mark.parametrize("viscous", [0, 1])
def test_mixed_compute_dt_matches_jax(viscous, dt_type):
    """MixedSolver mirrors the JAX MixedSolver's rule: the inviscid CFL
    limit over every block, one global float for dt_type 1 and 2."""
    p = vortex(viscous)
    p.dt_type, p.CFL = dt_type, 0.4
    mesh = periodic_mixed_mesh_2d(6, 6, -10, 10, -10, 10)
    js = JaxMixedSolver(p, mesh)
    ts = hifiles_tpu_torch.MixedSolver(run_input_from(p), mesh_from(mesh),
                                       device="cpu")
    u0 = tuple(seeded(a, seed=i) for i, a in enumerate(js.u))
    js.u = tuple(jnp.asarray(a) for a in u0)
    ts.set_state(u0, tuple(np.zeros_like(a) for a in u0), 0.0)
    want, got = js.compute_dt(), ts.compute_dt()
    assert isinstance(got, float) and want > 0
    assert abs(got - want) <= 1e-12 * want
    js.run(2, dt=want)
    ts.run(2, dt=got)
    for a, b in zip(js.u, ts.u):
        a = np.asarray(a)
        assert np.abs(a - b).max() < 1e-10 * max(np.abs(a).max(), 1.0)


RUNS = {
    "hex_local": lambda: (tgv(), periodic_hex_mesh(4, 4, 4), 2),
    "hex_global": lambda: (tgv(), periodic_hex_mesh(4, 4, 4), 1),
    "quad_local": lambda: (vortex(0), periodic_quad_mesh(6, 6, -10, 10, -10,
                                                         10), 2),
    # the featured loop: body forcing and running averages take the
    # smallest local step
    "channel_local": lambda: channel_twin() + (2,),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_cfl_steps_match_jax(case):
    """5 steps, each with the step its solver's compute_dt gives (the
    driver's loop): the state, the clock and the featured carry agree."""
    p, mesh, dt_type = RUNS[case]()
    js, ts = pair(p, mesh, dt_type, CFL=0.2)
    u0 = ts.u
    for _ in range(5):
        js.run(1, dt=js.compute_dt())
        ts.run(1, dt=ts.compute_dt())
    a, b = np.asarray(js.u), ts.u
    scale = max(np.abs(a).max(), 1.0)
    assert np.isfinite(b).all() and np.abs(b - u0).max() > 1e-6 * scale
    assert np.abs(a - b).max() < 1e-10 * scale, np.abs(a - b).max()
    assert ts.time == pytest.approx(js.time, rel=1e-12)
    if ts._avg:
        ua = np.asarray(js.u_avg)
        assert np.abs(ua - ts.u_avg).max() < 1e-10 * scale
        assert float(ts._t_sim) == pytest.approx(float(js._t_sim), rel=1e-12)
    if ts._forcing:
        assert abs(ts.mdot_old - float(js._mdot_old)) < 1e-10


def test_local_dt_array_from_numpy():
    """run() takes the local dt as a numpy (E,) array too, as the JAX run
    does, and the clock advances by its minimum."""
    js, ts = pair(tgv(), periodic_hex_mesh(4, 4, 4), 2)
    dt = np.asarray(js.compute_dt())
    js.run(2, dt=dt)
    ts.run(2, dt=dt)
    assert ts.time == js.time == pytest.approx(2 * dt.min(), rel=1e-15)
    a = np.asarray(js.u)
    assert np.abs(a - ts.u).max() < 1e-10 * max(np.abs(a).max(), 1.0)


@pytest.mark.parametrize("adv_type", [0, 1, 2, 3, 4])
def test_step_with_local_dt_matches_jax(adv_type):
    """Each RK scheme with a per-element dt on a fixed linear rhs: the
    port's (1, 1, E) plane in place on (U, F, E) against the JAX step's
    (E, 1, 1) on (E, U, F) (solver/step.py)."""
    from hifiles_tpu.solver.step import make_step_fn as jax_step_fn
    from hifiles_tpu_torch.solver.step import make_step_fn
    rng = np.random.default_rng(4)
    u0, reg0, c = (rng.random((6, 5, 4)) for _ in range(3))      # (E, U, F)
    dt = 0.05 + 0.1 * rng.random(6)
    uj, rj = jax_step_fn(lambda u: -0.5 * u + c, adv_type)(
        jnp.asarray(u0), jnp.asarray(reg0), jnp.asarray(dt)[:, None, None])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(1, 2, 0)))
    ct = t(c)
    ut, rt = t(u0), t(reg0)
    ut2, rt2 = make_step_fn(lambda u: -0.5 * u + ct, adv_type)(
        ut, rt, torch.from_numpy(dt).view(1, 1, -1))
    assert ut2 is ut
    np.testing.assert_allclose(ut.numpy().transpose(2, 0, 1), np.asarray(uj),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(rt2.numpy().transpose(2, 0, 1), np.asarray(rj),
                               rtol=0, atol=1e-14)
