"""The featured time loop of the PyTorch port (BC ramp counter, body
forcing, running time averages; the JAX package's "SoA featured (fast)"
chunk, solver.py:380-482) against the JAX Solver at f64 on the CPU, and the
step's source term against solver/step.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.config.params import RunInput
from hifiles_tpu.mesh.generate import channel_hex_mesh
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_boundaries import DUCT, duct_input, duct_mesh  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNEL_DECK = os.path.join(ROOT, "tests", "decks", "input_channel_les_bench")


def channel_twin(spinup_steps=0.0, **attrs):
    """The channel bench deck at order 2 (the small twin of
    tests/test_featured_fast_path.py:73-86) with ``attrs`` set and a
    spin-up time of ``spinup_steps`` time steps."""
    p = RunInput.from_deck(CHANNEL_DECK)
    p.order = 2
    p.spinup_time = spinup_steps * p.dt
    for k, v in attrs.items():
        setattr(p, k, v)
    return p, channel_hex_mesh(4, 4, 2)


def ramped_duct():
    p = duct_input(*DUCT["ramp_lin"])
    p.dt = 1e-4
    return p, duct_mesh()


CONFIGS = {
    "channel": lambda: channel_twin(),
    "body_force_type_1": lambda: channel_twin(body_force_type=1),
    # averaging restarts until t_sim passes the spin-up time
    "spinup": lambda: channel_twin(spinup_steps=4.5),
    "ramped_duct": ramped_duct,
}


def _pair(config, n=10):
    """Both Solvers from the JAX solver's initial state, perturbed by 1%
    from a seed so that the walls and the forcing do work from the first
    step, after n steps."""
    p, mesh = CONFIGS[config]()
    js = JaxSolver(p, mesh)
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    assert js.run_path == "SoA featured (fast)", js.run_path
    rng = np.random.default_rng(5)
    u0 = np.asarray(js.u) * (1.0 + 0.01 * rng.random(js.u.shape))
    js.u = jnp.asarray(u0)
    ts.set_state(u0, np.zeros_like(u0), 0.0)
    js.run(n, dt=p.dt)
    ts.run(n, dt=p.dt)
    return js, ts, u0


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_featured_steps_match_jax(config):
    js, ts, u0 = _pair(config)
    a, b = np.asarray(js.u), ts.u
    assert np.isfinite(b).all() and np.abs(a - u0).max() > 0
    scale = max(np.abs(a).max(), 1.0)
    assert np.abs(a - b).max() < 1e-10 * scale, np.abs(a - b).max()
    assert ts.time == pytest.approx(js.time, rel=1e-15)
    if js._avg:
        ua, ub = np.asarray(js.u_avg), ts.u_avg
        assert ub.shape == ua.shape == a.shape[:2] + (5,)
        assert np.abs(ua - ub).max() < 1e-10 * scale, np.abs(ua - ub).max()
    if js._forcing:
        m_j, m_t = float(js._mdot_old), ts.mdot_old
        assert m_t != js.p.body_force_mdot0
        assert abs(m_t - m_j) < 1e-10 * max(abs(m_j), 1.0), (m_t, m_j)
        for x, y in zip(ts.inflow_massflux(), js.inflow_massflux()):
            assert abs(x - y) <= 1e-10 * max(abs(y), 1.0), (x, y)
    if js._has_ramp:
        assert float(ts._k) == float(js._iter_k) == 11.0


def test_spinup_restarts_average():
    """With spin-up 4.5 dt the average is the current state until t_sim
    passes it, then a running mean: after 5 steps it equals the state."""
    p, mesh = CONFIGS["spinup"]()
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    ts.run(5, dt=p.dt)
    u = ts.u
    rho = u[..., 0]
    np.testing.assert_array_equal(ts.u_avg[..., 0], rho)
    np.testing.assert_array_equal(ts.u_avg[..., 1], u[..., 1] / rho)
    ts.run(1, dt=p.dt)
    assert not np.array_equal(ts.u_avg[..., 0], ts.u[..., 0])


def test_set_state_takes_featured_carry():
    p, mesh = CONFIGS["channel"]()
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    u = ts.u
    avg = np.random.default_rng(0).random(u.shape[:2] + (5,))
    ts.set_state(u, np.zeros_like(u), 0.5, iter_k=7, mdot_old=6.0,
                 t_sim=0.25, u_avg=avg)
    assert float(ts._k) == 7.0 and ts.mdot_old == 6.0
    assert float(ts._t_sim) == 0.25 and ts.time == 0.5
    np.testing.assert_array_equal(ts.u_avg, avg)
    assert ts._t_sim.dtype == ts._k.dtype == torch.float64


@pytest.mark.parametrize("adv_type", [0, 1, 2, 3, 4])
def test_step_source_matches_jax(adv_type):
    """One step of each RK scheme with a source column (the body force's
    (F, 1) shape) added to a linear rhs, against solver/step.py's
    source_fn: the port's solvers add the source to the stage rhs they
    hand the step."""
    from hifiles_tpu.solver.step import make_step_fn as jax_step_fn
    from hifiles_tpu_torch.solver.step import make_step_fn
    rng = np.random.default_rng(6)
    u0, reg0, c = (rng.random((6, 5, 4)) for _ in range(3))
    src = rng.random((5, 1))
    dt = 0.1
    uj, rj = jax_step_fn(lambda u: -0.5 * u + c, adv_type,
                         source_fn=lambda u: jnp.asarray(src))(
        jnp.asarray(u0), jnp.asarray(reg0), dt)
    ct, st = torch.from_numpy(c), torch.from_numpy(src)
    ut, rt = torch.from_numpy(u0.copy()), torch.from_numpy(reg0.copy())
    ut2, rt2 = make_step_fn(lambda u: (-0.5 * u + ct).add_(st),
                            adv_type)(ut, rt, dt)
    assert ut2 is ut
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(rt2.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-14)
