"""Boundary conditions and wall models of the PyTorch port against the JAX
package at f64 on the CPU.

The residual cases hold hifiles_tpu_torch's make_residual_soa with
boundary functions against the JAX make_residual_soa with
make_bc_functions, at the tolerance of tests/test_residual_soa.py
(1e-10 * max(scale, 1)), on a perturbed state: every wall flag on the hex
channel (cyclic x/z), every inflow/outflow pair on a hex duct (the periodic
box with its x faces relabelled, as tests/test_residual_soa.py:145-160
relabels a quad mesh), the three Riemann solvers, LES and SA-RANS on the
walled channel, with geometry compression on and off."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.config.params import (AD_WALL, ADIABAT_WALL, CHAR, CYCLIC,
                                       ISOTHERM_WALL, SLIP_WALL,
                                       SLIP_WALL_DUAL, SUB_IN_CHAR,
                                       SUB_IN_SIMP, SUB_OUT_CHAR,
                                       SUB_OUT_SIMP, SUP_IN, SUP_OUT,
                                       BCParams, RunInput)
from hifiles_tpu.mesh.generate import channel_hex_mesh, periodic_hex_mesh
from hifiles_tpu.models.wall_model import wall_stress_flux as jax_wall_flux
from hifiles_tpu.solver import residual_soa as jrs
from hifiles_tpu.solver.bc import make_bc_functions as jax_bc_functions
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.models.wall_model import wall_stress_flux
from hifiles_tpu_torch.solver import residual_soa as trs
from hifiles_tpu_torch.solver.bc import make_bc_functions

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_features import deck  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNEL_DECK = os.path.join(ROOT, "tests", "decks", "input_channel_les_bench")


def channel_input(order=2, les=0, rans=0, riemann=3, wall_model=0):
    """The channel bench deck (uniform Mach-0.2 x-flow, cyclic x/z) at
    ``order``, with LES, SA-RANS, the Riemann solver and the wall model
    set after setup_params."""
    p = RunInput.from_deck(CHANNEL_DECK)
    p.order = order
    p.LES, p.RANS, p.wall_model = les, rans, wall_model
    p.riemann_solve_type = riemann
    p.forcing, p.average_fields = 0, []
    return p


def wall_bc(flag, use_wm=0):
    kw = dict(use_wm=use_wm)
    if flag == ISOTHERM_WALL:
        kw.update(T_static=1.05, velocity=(0.2, 0.0, 0.0))
    return BCParams(name="Wall", flag=flag, **kw)


def duct_mesh(nx=4, ny=3, nz=3):
    """The periodic hex box with its x- faces in group 1 ("Inflow") and
    its x+ faces in group 2 ("Outflow"); y and z stay cyclic."""
    mesh = periodic_hex_mesh(nx, ny, nz)
    for c in range(mesh.n_cells):
        if c % nx == 0:
            mesh.bc_id[c, 4] = 1
        if c % nx == nx - 1:
            mesh.bc_id[c, 2] = 2
    mesh.bc_names = ["Cyclic", "Inflow", "Outflow"]
    return mesh


def duct_input(inflow, outflow, riemann=3):
    """The TGV deck of tests/test_torch_features.py (rho ~ 1, p ~ 71.4,
    T ~ 1, sound speed 10) with the duct's BC groups."""
    p = deck(order=2)
    p.riemann_solve_type = riemann
    p.bc_list = [BCParams(name="Cyclic", flag=CYCLIC), inflow, outflow]
    return p


# inflow/outflow pairs of the duct, BC values in the deck's scales
DUCT = {
    "sub_simp": (BCParams(name="Inflow", flag=SUB_IN_SIMP, rho=1.0,
                          velocity=(1.0, 0.0, 0.0)),
                 BCParams(name="Outflow", flag=SUB_OUT_SIMP, p_static=71.0,
                          T_total=1.0)),
    "sub_char": (BCParams(name="Inflow", flag=SUB_IN_CHAR, p_total=72.2,
                          T_total=1.01, nx=1.0, ny=0.0, nz=0.0),
                 BCParams(name="Outflow", flag=SUB_OUT_CHAR,
                          p_static=71.0)),
    "sup": (BCParams(name="Inflow", flag=SUP_IN, rho=1.0,
                     velocity=(12.0, 0.0, 0.0), p_static=71.4),
            BCParams(name="Outflow", flag=SUP_OUT)),
    "char": (BCParams(name="Inflow", flag=CHAR, rho=1.0,
                      velocity=(1.0, 0.0, 0.0), p_static=71.4),
             BCParams(name="Outflow", flag=CHAR, rho=1.0,
                      velocity=(-0.5, 0.1, 0.0), p_static=71.2)),
    # SUB_IN_CHAR ramped toward its totals: linear in T, and the
    # isentropic temperature from the local state (T_ramp_coeff < 0)
    "ramp_lin": (BCParams(name="Inflow", flag=SUB_IN_CHAR, p_total=72.2,
                          T_total=1.01, nx=1.0, ny=0.0, nz=0.0,
                          pressure_ramp=1, p_ramp_coeff=0.05,
                          T_ramp_coeff=0.05, p_total_old=71.5,
                          T_total_old=1.0),
                 BCParams(name="Outflow", flag=SUB_OUT_SIMP, p_static=71.0,
                          T_total=1.0)),
    "ramp_isen": (BCParams(name="Inflow", flag=SUB_IN_CHAR, p_total=72.2,
                           T_total=1.01, nx=1.0, ny=0.0, nz=0.0,
                           pressure_ramp=1, p_ramp_coeff=0.05,
                           T_ramp_coeff=-1.0, p_total_old=71.5,
                           T_total_old=1.0),
                  BCParams(name="Outflow", flag=SUB_OUT_SIMP, p_static=71.0,
                           T_total=1.0)),
}

# case -> (kind, arguments, compress)
CASES = {
    "adiabat": ("wall", dict(flag=ADIABAT_WALL)),
    "adiabat_wm1": ("wall", dict(flag=ADIABAT_WALL, use_wm=1, wall_model=1)),
    "adiabat_wm2": ("wall", dict(flag=ADIABAT_WALL, use_wm=1, wall_model=2)),
    "isotherm": ("wall", dict(flag=ISOTHERM_WALL)),
    "isotherm_wm1": ("wall", dict(flag=ISOTHERM_WALL, use_wm=1,
                                  wall_model=1)),
    "isotherm_wm2": ("wall", dict(flag=ISOTHERM_WALL, use_wm=1,
                                  wall_model=2)),
    "slip": ("wall", dict(flag=SLIP_WALL)),
    "slip_dual": ("wall", dict(flag=SLIP_WALL_DUAL)),
    "adiabat_rusanov": ("wall", dict(flag=ADIABAT_WALL, riemann=0)),
    "adiabat_roem": ("wall", dict(flag=ADIABAT_WALL, riemann=2)),
    "slip_dual_roem": ("wall", dict(flag=SLIP_WALL_DUAL, riemann=2)),
    "les_smagorinsky": ("wall", dict(flag=ADIABAT_WALL, les=1)),
    "les_smagorinsky_wm1": ("wall", dict(flag=ADIABAT_WALL, les=1,
                                         use_wm=1, wall_model=1)),
    "rans_adiabat": ("wall", dict(flag=ADIABAT_WALL, rans=1, riemann=0)),
    "rans_isotherm": ("wall", dict(flag=ISOTHERM_WALL, rans=1, riemann=0)),
    "duct_sub_simp": ("duct", dict(pair="sub_simp")),
    "duct_sub_char": ("duct", dict(pair="sub_char")),
    "duct_sup": ("duct", dict(pair="sup")),
    "duct_char": ("duct", dict(pair="char")),
    "duct_char_rusanov": ("duct", dict(pair="char", riemann=0)),
    "duct_char_roem": ("duct", dict(pair="char", riemann=2)),
    "duct_ramp_lin": ("duct", dict(pair="ramp_lin", ramp=3.0)),
    "duct_ramp_isen": ("duct", dict(pair="ramp_isen", ramp=3.0)),
}
PARAMS = [(c, True) for c in sorted(CASES)] + [
    (c, False) for c in ("adiabat_wm1", "isotherm", "les_smagorinsky",
                         "duct_sub_char", "duct_ramp_lin")]


def build(case):
    """(JAX solver, port solver, p) of a case."""
    kind, a = CASES[case]
    if kind == "wall":
        p = channel_input(les=a.get("les", 0), rans=a.get("rans", 0),
                          riemann=a.get("riemann", 3),
                          wall_model=a.get("wall_model", 0))
        p.bc_list = [BCParams(name="Cyclic", flag=CYCLIC),
                     wall_bc(a["flag"], a.get("use_wm", 0))]
        mesh = channel_hex_mesh(4, 4, 2)
    else:
        p = duct_input(*DUCT[a["pair"]], riemann=a.get("riemann", 3))
        mesh = duct_mesh()
    js = JaxSolver(p, mesh)
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    return js, ts, p


def perturbed(js, p, seed=0):
    """The JAX solver's initial state perturbed by 2% from a seed, nu~ at
    five times mu_inf for RANS; (U, F, E)."""
    u = np.asarray(js.u).copy()
    if p.RANS:
        u[..., -1] = 5.0 * p.mu_inf
    rng = np.random.default_rng(seed)
    u = u * (1.0 + 0.02 * rng.random(u.shape))
    return np.ascontiguousarray(np.transpose(u, (1, 2, 0)))


@pytest.mark.parametrize("case,compress", PARAMS)
def test_boundary_residual_matches_jax(case, compress, monkeypatch):
    if compress:
        monkeypatch.delenv("HIFILES_NO_GEO_COMPRESS", raising=False)
    else:
        monkeypatch.setenv("HIFILES_NO_GEO_COMPRESS", "1")
    js, ts, p = build(case)
    assert ts.block.bdy_slot.size and ts._bc_fns is not None
    ramp = CASES[case][1].get("ramp")
    jfn = jrs.make_residual_soa(js.block, js.rcfg, jnp.float64, js._bc_fns)
    assert jfn is not None
    u = perturbed(js, p)
    want = np.asarray(jfn(jnp.asarray(u), ramp=None if ramp is None
                          else jnp.asarray(ramp)))
    tfn = trs.make_residual_soa(ts.block, ts.rcfg, "cpu", torch.float64,
                                ts._bc_fns)
    got = tfn(torch.from_numpy(u), ramp=None if ramp is None
              else torch.tensor(ramp, dtype=torch.float64)).numpy()
    assert got.shape == want.shape == u.shape
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 0
    err = np.abs(got - want).max()
    assert err < 1e-10 * max(scale, 1.0), (err, scale)


def test_boundary_cases_cover_flags():
    """The parametrised cases reach what they are named for: every NS BC
    flag, the wall-model tables, the ramp branches, and a ramp that moves
    the residual."""
    flags = set()
    for case, (kind, a) in CASES.items():
        if kind == "wall":
            flags.add(a["flag"])
        else:
            flags |= {b.flag for b in DUCT[a["pair"]]}
    assert flags == {SUB_IN_SIMP, SUB_OUT_SIMP, SUB_IN_CHAR, SUB_OUT_CHAR,
                     SUP_IN, SUP_OUT, SLIP_WALL, ISOTHERM_WALL,
                     ADIABAT_WALL, CHAR, SLIP_WALL_DUAL}
    js, ts, p = build("adiabat_wm2")
    assert ts._bc_fns.wm_tables is not None
    assert ts._bc_fns.wm_tables[0].shape == (ts.block.bdy_bcid.size,)
    js, ts, p = build("duct_ramp_isen")
    u = torch.from_numpy(perturbed(js, p))
    r0 = ts.residual_soa(u)
    r1 = ts.residual_soa(u, ramp=torch.tensor(3.0, dtype=torch.float64))
    assert ts._bc_fns.has_ramp and not torch.equal(r0, r1)


def test_slot_coverage_counts_boundary_faces():
    """On the walled channel every y-face flux point is a boundary slot;
    interior and boundary slots together cover each flux point once."""
    js, ts, p = build("adiabat")
    T = trs.SoaTables(ts.block)
    E, Pf = ts.block.n_eles, ts.ops.n_fpts
    allslots = np.concatenate([T.slot_l.ravel(), T.slot_r.ravel(),
                               T.slot_b.ravel()])
    assert np.array_equal(np.sort(allslots), np.arange(E * Pf))
    nfp = T.nfp
    lf_b = (T.slot_b[0] % Pf) // nfp
    assert set(lf_b.tolist()) == {1, 3}            # the y- and y+ faces
    assert T.slot_b.shape == (nfp, 2 * 4 * 2)


# ----------------------------------------------------------------------
# wall_stress_flux
# ----------------------------------------------------------------------

def _wall_inputs(seed, n=64, wide=False):
    """Seeded input states (wall-parallel flow ~1), no-slip wall states,
    distances and unit normals; ``wide`` spreads the distance over four
    decades so that Werner-Wengle takes both branches."""
    rng = np.random.default_rng(seed)
    u_wm = np.empty((n, 5))
    u_wm[:, 0] = 1.0 + 0.1 * rng.random(n)
    vel = rng.normal(size=(n, 3))
    vel *= rng.uniform(0.5, 2.0, (n, 1)) / np.linalg.norm(vel, axis=1,
                                                          keepdims=True)
    u_wm[:, 1:4] = u_wm[:, :1] * vel
    u_wm[:, 4] = 40.0 + 0.5 * u_wm[:, 0] * (vel**2).sum(1)
    u_w = np.empty((n, 5))
    u_w[:, 0] = 1.0 + 0.1 * rng.random(n)
    vw = 0.05 * rng.normal(size=(n, 3))
    u_w[:, 1:4] = u_w[:, :1] * vw
    u_w[:, 4] = 42.0 + 0.5 * u_w[:, 0] * (vw**2).sum(1)
    dist = (10.0 ** rng.uniform(-4, 0, n) if wide
            else 0.05 + 0.1 * rng.random(n))
    norm = rng.normal(size=(n, 3))
    norm /= np.linalg.norm(norm, axis=1, keepdims=True)
    return u_wm, u_w, dist, norm


@pytest.mark.parametrize("model,fix_vis", [(1, 1), (1, 0), (2, 1), (2, 0)])
def test_wall_stress_flux_matches_jax(model, fix_vis):
    u_wm, u_w, dist, norm = _wall_inputs(model + 2 * fix_vis,
                                         wide=model == 1)
    kw = dict(wall_model=model, gamma=1.4, prandtl=0.72, prandtl_t=0.9,
              mu_inf=1e-3, rt_inf=16.0, c_sth=0.368, fix_vis=fix_vis,
              kappa=0.41, n_dims=3)
    want = np.asarray(jax_wall_flux(jnp.asarray(u_wm), jnp.asarray(u_w),
                                    jnp.asarray(dist), jnp.asarray(norm),
                                    **kw))
    planes = lambda a: list(torch.from_numpy(np.ascontiguousarray(a.T)))
    got = torch.stack(wall_stress_flux(
        planes(u_wm), planes(u_w), torch.from_numpy(dist), planes(norm),
        **kw)).numpy().T
    assert got.shape == want.shape == u_wm.shape
    assert np.isfinite(want).all() and np.abs(want[:, 1:4]).max() > 0
    if model == 1:
        # both Werner-Wengle branches (ref:wall_model_funcs.cpp:52-79)
        v = u_wm[:, 1:4] / u_wm[:, :1]
        inte = u_wm[:, 4] / u_wm[:, 0] - 0.5 * (v**2).sum(1)
        rt = 0.4 * inte / 16.0
        mu = 1e-3 if fix_vis else 1e-3 * rt**1.5 * 1.368 / (rt + 0.368)
        v_par = v - norm * (v * norm).sum(1, keepdims=True)
        v_rel = v_par - u_w[:, 1:4] / u_w[:, :1]
        rey = u_wm[:, 0] * np.linalg.norm(v_rel, axis=1) * dist / mu
        assert (rey < 11.81**2).any() and (rey > 2 * 11.81**2).any()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


# ----------------------------------------------------------------------
# turbulent inlets, AD_WALL, equation 1 and the inlet's fluctuations
# ----------------------------------------------------------------------

def test_turbulent_inlet_raises():
    """A turbulent inlet (an inflow with inlet_type > 0 under LES), once
    refused, now builds the white-noise inlet and steps."""
    p = duct_input(BCParams(name="Inflow", flag=SUB_IN_SIMP, rho=1.0,
                            velocity=(1.0, 0.0, 0.0), inlet_type=1,
                            turb_1=1e-4),
                   DUCT["sub_simp"][1])
    p.LES, p.SGS_model = 1, 0
    s = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(duct_mesh()),
                                 device="cpu")
    assert s.turb_inlet.inlet_type == 1 and s.turb_inlet.in_faces.size == 9
    s.run(1, dt=p.dt)
    assert np.isfinite(s.u).all()
    assert float(s._fluc.abs().max()) > 0


def test_ad_wall_raises():
    """AD_WALL, once refused, now builds: under equation 0 its candidate
    ghost state is zero (bc.py:309-310 of the JAX package), as the JAX
    boundary functions give it."""
    ts = hifiles_tpu_torch.Solver(run_input_from(channel_input()),
                                  mesh_from(channel_hex_mesh(3, 2, 2)),
                                  device="cpu")
    p = channel_input()
    p.bc_list = [BCParams(name="Cyclic", flag=CYCLIC),
                 BCParams(name="Wall", flag=AD_WALL)]
    bc = make_bc_functions(run_input_from(p), ts.block, ts.rcfg, "cpu",
                           torch.float64)
    assert AD_WALL in bc.flags
    trs.make_residual_soa(ts.block, ts.rcfg, "cpu", torch.float64, bc)
    hifiles_tpu_torch.Solver(run_input_from(p),
                             mesh_from(channel_hex_mesh(3, 2, 2)),
                             device="cpu")
    js = JaxSolver(p, channel_hex_mesh(3, 2, 2))
    jbc = jax_bc_functions(p, js.block, js.rcfg, jnp.float64)
    u = np.asarray(js.u)[js.block.bdy_slot // js.ops.n_fpts, 0]
    norm = js.block.norm_fpts[js.block.bdy_slot]
    want = np.asarray(jbc.ghost_state(jnp.asarray(u), jnp.asarray(norm), 0))
    got = bc.ghost_state(list(torch.as_tensor(u.transpose(2, 1, 0))),
                         list(torch.as_tensor(norm.transpose(2, 1, 0))), 0)
    got = torch.stack(got).numpy().transpose(2, 1, 0)
    assert np.array_equal(got, want) and not want.any()


def test_equation_1_raises():
    """Equation 1, once refused, now builds on a box walled by AD_WALL:
    one scalar field, the Lax-Friedrichs flux, zero ghost states."""
    p = channel_input()
    p.equation, p.riemann_solve_type, p.ic_form, p.test_case = 1, 1, 2, 2
    p.wave_speed, p.diff_coeff = (1.0, 0.5, 0.25), 0.05
    p.bc_list = [BCParams(name="Cyclic", flag=CYCLIC),
                 BCParams(name="Wall", flag=AD_WALL)]
    s = hifiles_tpu_torch.Solver(run_input_from(p),
                                 mesh_from(channel_hex_mesh(3, 2, 2)),
                                 device="cpu")
    assert s.n_fields == 1 and s._bc_fns.scalar
    assert np.isfinite(s.residual_norm(1)).all()


def test_fluc_raises():
    """The inlet's fluctuations, once refused, enter the inflow ghost
    states: the residual with a seeded fluc against the JAX residual_soa
    with the same fluc (AoS (Fb, nfp, d) there, planes (d, nfp, Fb)
    here)."""
    js, ts, p = build("duct_sub_simp")
    u = perturbed(js, p)
    rng = np.random.default_rng(5)
    fluc = 0.05 * rng.standard_normal(js.block.bdy_slot.shape + (3,))
    jfn = jrs.make_residual_soa(js.block, js.rcfg, jnp.float64, js._bc_fns)
    want = np.asarray(jfn(jnp.asarray(u), fluc=jnp.asarray(fluc)))
    got = ts.residual_soa(torch.from_numpy(u), fluc=torch.as_tensor(
        np.ascontiguousarray(fluc.transpose(2, 1, 0)))).numpy()
    base = ts.residual_soa(torch.from_numpy(u)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - base).max() > 1e-6 * scale
    assert np.abs(got - want).max() < 1e-10 * max(scale, 1.0)


def test_bc_function_tables_match_jax():
    """The port's per-face BC tables and wall-model tables against the JAX
    make_bc_functions on the wall-modelled channel."""
    js, ts, p = build("isotherm_wm1")
    jb = jax_bc_functions(p, js.block, js.rcfg, jnp.float64)
    tb = ts._bc_fns
    for a, b in zip(jb.wm_tables, tb.wm_tables):
        np.testing.assert_array_equal(np.asarray(a), b.numpy().ravel())
    assert tb.flags == [ISOTHERM_WALL]
