"""Feature physics of the PyTorch port on the periodic hex box: LES (the SGS
models and SVV), over-integration, SA-RANS, RoeM, Sutherland viscosity and
shock capture, against the JAX package at f64 on the CPU.

Residuals are held against the JAX make_residual_soa with the tolerance of
tests/test_residual_soa.py (1e-10 * max(scale, 1)); the SVV and shock
capture cases compare 5 steps of the two Solvers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.config.params import RunInput
from hifiles_tpu.mesh.generate import periodic_hex_mesh
from hifiles_tpu.ops.stabilization import make_shock_capture_soa as jax_capture
from hifiles_tpu.ops.stabilization import persson_top_mode_mask
from hifiles_tpu.solver import residual_soa as jrs
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.ops.stabilization import make_shock_capture_soa
from hifiles_tpu_torch.solver import residual_soa as trs

torch.set_num_threads(1)


def deck(order=2, after=(), **attrs):
    """The TGV deck of tests/test_les.py with ``attrs`` set before
    setup_params (which makes the RANS free-stream values) and ``after``
    set after it: turning viscosity off there, as tests/test_residual_soa.py
    does, keeps the TGV initial condition of the viscous reference scales,
    and RoeM with RANS passes the deck check (the residual takes it)."""
    p = RunInput()
    p.equation, p.viscous, p.order, p.ic_form = 0, 1, order, 7
    p.adv_type, p.riemann_solve_type = 3, 3
    p.dt_type, p.dt, p.n_steps = 0, 1e-4, 0
    p.vcjh_scheme_hexa = 1
    p.C_s, p.filter_ratio, p.filter_type = 0.1, 2.0, 2
    p.dx_cyclic = p.dy_cyclic = p.dz_cyclic = 2 * np.pi
    p.gamma, p.R_gas, p.fix_vis = 1.4, 286.9, 1
    p.Mach_free_stream, p.T_free_stream = 0.1, 300.0
    p.rho_free_stream = 0.0008421095852102401
    p.mu_gas = 1.827e-5
    p.Mach_c_ic, p.T_c_ic, p.rho_c_ic = 0.1, 300.0, 0.0008421095852102401
    for k, v in attrs.items():
        setattr(p, k, v)
    p.setup_params()
    for k, v in dict(after).items():
        setattr(p, k, v)
    return p


CASES = {
    "les_smagorinsky": dict(LES=1, SGS_model=0),
    "les_wale": dict(LES=1, SGS_model=1),
    "les_wale_similarity": dict(LES=1, SGS_model=2),
    "les_similarity": dict(LES=1, SGS_model=4),
    "over_int_viscous": dict(order=3, over_int=1, over_int_order=4),
    "over_int_inviscid": dict(order=3, over_int=1, over_int_order=4,
                              after=dict(viscous=0, mu_inf=float("nan")),
                              riemann_solve_type=0),
    "rans_rusanov": dict(RANS=1, riemann_solve_type=0),
    "rans_roem": dict(RANS=1, riemann_solve_type=0,
                      after=dict(riemann_solve_type=2)),
    "roem_viscous": dict(riemann_solve_type=2),
    "sutherland": dict(fix_vis=0),
    "over_int_les_wale_similarity": dict(LES=1, SGS_model=2, over_int=1,
                                         over_int_order=4),
}


def _state(js, p, seed=0):
    """The JAX solver's initial state perturbed by 2% from a seed (as
    tests/test_residual_soa.py::_perturbed), nu~ seeded at the free-stream
    level for RANS; (U, F, E)."""
    u = np.asarray(js.u).copy()
    if p.RANS:
        u[..., -1] = p.mu_tilde_inf
    rng = np.random.default_rng(seed)
    u = u * (1.0 + 0.02 * rng.random(u.shape))
    return np.ascontiguousarray(np.transpose(u, (1, 2, 0)))


# every case with geometry compression on, three with it off
PARAMS = [(c, True) for c in sorted(CASES)] + [
    (c, False) for c in ("les_smagorinsky", "over_int_viscous",
                         "rans_rusanov")]


@pytest.mark.parametrize("case,compress", PARAMS)
def test_residual_matches_jax(case, compress, monkeypatch):
    if compress:
        monkeypatch.delenv("HIFILES_NO_GEO_COMPRESS", raising=False)
    else:
        monkeypatch.setenv("HIFILES_NO_GEO_COMPRESS", "1")
    p = deck(**CASES[case])
    mesh = periodic_hex_mesh(3, 3, 3)
    js = JaxSolver(p, mesh)
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    u = _state(js, p)
    want = np.asarray(jrs.make_residual_soa(js.block, js.rcfg, jnp.float64)(
        jnp.asarray(u)))
    got = trs.make_residual_soa(ts.block, ts.rcfg, "cpu", torch.float64)(
        torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == u.shape
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 0
    err = np.abs(got - want).max()
    assert err < 1e-10 * max(scale, 1.0), (err, scale)


def test_residual_cases_cover_configs():
    """The parametrised residual cases exercise what they are named for:
    the port's residual builds the over-int operators, the SA field and
    the SGS planes for them."""
    p = deck(**CASES["rans_roem"])
    ts = hifiles_tpu_torch.Solver(run_input_from(p),
                                  mesh_from(periodic_hex_mesh(3, 3, 3)),
                                  device="cpu")
    assert ts.rcfg.rans and ts.rcfg.n_fields == 6
    assert ts.rcfg.riemann_solve_type == trs.ROEM
    p = deck(**CASES["over_int_viscous"])
    ts = hifiles_tpu_torch.Solver(run_input_from(p),
                                  mesh_from(periodic_hex_mesh(3, 3, 3)),
                                  device="cpu")
    assert ts.block.jginv_over is not None
    assert ts.block.opp_over.shape == (5 ** 3, 4 ** 3)


@pytest.mark.parametrize("config", ["shock", "svv"])
def test_steps_match_jax(config):
    """5 RK45 steps of the port's Solver against the JAX Solver: shock
    capture at s0 = 0 (the filter fires everywhere) and SVV (sgs_model 3,
    the per-step solution filter)."""
    attrs = (dict(order=3, shock_cap=1, s0=0.0) if config == "shock"
             else dict(LES=1, SGS_model=3))
    p = deck(**attrs)
    mesh = periodic_hex_mesh(3, 3, 3)
    js = JaxSolver(p, mesh)
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    u0 = np.asarray(js.u)
    ts.set_state(u0, np.zeros_like(u0), 0.0)
    js.run(5, dt=p.dt)
    ts.run(5, dt=p.dt)
    a, b = np.asarray(js.u), ts.u
    assert np.isfinite(b).all()
    assert np.abs(a - u0).max() > 0
    scale = max(np.abs(a).max(), 1.0)
    assert np.abs(a - b).max() < 1e-10 * scale, np.abs(a - b).max()


def test_shock_capture_matches_jax():
    """The Persson sensor + exp filter post-stage against the JAX SoA
    version, with s0 at the median sensor so that both branches run; the
    port's capture writes the state in place."""
    p = deck(order=3)
    ts = hifiles_tpu_torch.Solver(run_input_from(p),
                                  mesh_from(periodic_hex_mesh(3, 3, 3)),
                                  device="cpu")
    ops = ts.ops
    rng = np.random.default_rng(3)
    u = np.ascontiguousarray(np.transpose(np.asarray(ts.u), (1, 2, 0)))
    u = u * (1.0 + 0.1 * rng.random(u.shape))
    Vinv = ops.inv_vandermonde
    modal = Vinv @ u[:, 0]
    e2 = modal * modal * ops.modal_norms[:, None]
    top = persson_top_mode_mask(ops)[:, None]
    s0 = float(np.median((e2 * top).sum(0) / e2.sum(0)))
    kw = (s0, 36.0, 4, 0, 0, 3)
    want = np.asarray(jax_capture(ops, *kw, jnp.float64)(jnp.asarray(u)))
    ut = torch.from_numpy(u.copy())
    out = make_shock_capture_soa(ops, *kw, "cpu", torch.float64)(ut)
    assert out is ut
    changed = np.abs(want - u).max(axis=(0, 1)) > 0
    assert 0 < changed.sum() < changed.size
    np.testing.assert_allclose(ut.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("riemann", ["rusanov", "roem"])
def test_sa_face_flux_matches_jax(riemann):
    """F = 6 common flux on random face states: the SA row is carried
    (the SA working variable advects with the normal velocity)."""
    rng = np.random.default_rng(4)
    n = 40
    u_l, u_r = (rng.random((6, n)) + 1.0 for _ in range(2))
    for u in (u_l, u_r):
        u[4] += 10.0
        u[5] *= 1e-3
    nrm = rng.normal(size=(3, n))
    nrm /= np.linalg.norm(nrm, axis=0)
    jf = getattr(jrs, riemann + "_p")
    tf = getattr(trs, riemann + "_p")
    want = np.stack([np.asarray(x) for x in jf(
        list(jnp.asarray(u_l)), list(jnp.asarray(u_r)),
        list(jnp.asarray(nrm)), 1.4, 3)])
    got = torch.stack(tf(list(torch.from_numpy(u_l)),
                         list(torch.from_numpy(u_r)),
                         list(torch.from_numpy(nrm)), 1.4, 3)).numpy()
    assert got.shape == want.shape == (6, n)
    assert np.abs(want[5]).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-13 * np.abs(want).max())


def test_rans_f32_high_chi_finite():
    """f32 SA residual on the periodic box at chi ~= 5 (nu~ seeded at the
    free-stream level): the softplus in psi must not overflow
    (tests/test_residual_soa.py::test_soa_rans_f32_high_chi)."""
    p = deck(RANS=1, riemann_solve_type=0)
    ts = hifiles_tpu_torch.Solver(run_input_from(p),
                                  mesh_from(periodic_hex_mesh(3, 3, 3)),
                                  device="cpu", dtype=torch.float32)
    ts.u_soa[:, -1] = p.mu_tilde_inf
    chi = p.mu_tilde_inf / p.mu_inf
    assert chi == pytest.approx(5.0)
    r = ts.residual_soa(ts.u_soa)
    assert r.dtype == torch.float32 and torch.isfinite(r).all()
    assert r[:, -1].abs().max() > 0
