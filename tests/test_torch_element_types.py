"""Quad, tri and tet blocks in the PyTorch port (hifiles_tpu_torch): the
2-D volume stage, the simplex face pairing and the per-type operators,
against the JAX package at f64 on the CPU.

Residuals are held against the JAX make_residual_soa with the tolerance of
tests/test_residual_soa.py:29-36 (1e-10 * max(scale, 1)), with geometry
compression on and off; Solver runs compare the states after a few steps;
the isentropic vortex and the tet over-integration case are held against
the reference binary's goldens of tests/test_regression_reference.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.config.params import (ADIABAT_WALL, CYCLIC, ISOTHERM_WALL,
                                       SLIP_WALL, SLIP_WALL_DUAL, BCParams,
                                       RunInput)
from hifiles_tpu.mesh.generate import (channel_quad_mesh, periodic_quad_mesh,
                                       periodic_tet_mesh)
from hifiles_tpu.ops.stabilization import make_shock_capture_soa as jax_capture
from hifiles_tpu.solver import residual_soa as jrs
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.ops.stabilization import (make_shock_capture_soa,
                                                 persson_top_mode_mask)

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from chip_smoke import (last_stage_residual,  # noqa: E402
                        periodic_tri_mesh)
from test_face_path import tgv_input  # noqa: E402
from test_rans_viscous_bc import _rans_channel_input  # noqa: E402
from test_regression_reference import (TET_OVERINT_GOLD,  # noqa: E402
                                       VORTEX_L2_GOLD)
from test_turb_inlet import les_channel_input  # noqa: E402

torch.set_num_threads(1)

DECKS = os.path.join(os.path.dirname(__file__), "decks")


def vortex_deck(order=3, **attrs):
    """bench.mixed_input's 2-D viscous isentropic vortex (HLLC, dt 1e-4) at
    ``order``, with ``attrs`` set."""
    p = RunInput()
    p.equation, p.viscous, p.order = 0, 1, order
    p.ic_form, p.test_case, p.adv_type = 0, 1, 3
    p.riemann_solve_type = 3
    p.dt_type, p.dt = 0, 1e-4
    p.mach_free_stream = 0.3
    p.dx_cyclic = p.dy_cyclic = 20.0
    p.mu_inf, p.rt_inf, p.c_sth = 1e-4, 1.0, 0.0
    p.fix_vis, p.prandtl = 1, 0.72
    for k, v in attrs.items():
        setattr(p, k, v)
    return p


def quad_box():
    return periodic_quad_mesh(4, 4, -10, 10, -10, 10)


def tri_box():
    return periodic_tri_mesh(4, 4, -10, 10, -10, 10)


def quad_channel_boundaries():
    p = les_channel_input(inlet_type=0)
    p.LES = 0
    return p, channel_quad_mesh(8, 4, 0.0, 2.0, 0.0, 1.0), 0.01


def _walled(p, wall):
    p.bc_list = [BCParams(name="Cyc", flag=CYCLIC),
                 BCParams(name="CycX", flag=CYCLIC), wall]
    mesh = channel_quad_mesh(8, 4, 0.0, 4.0, 0.0, 1.0,
                             bc_x="Cyc", bc_X="Cyc", bc_y="Wall")
    mesh.bc_id[mesh.bc_id == 1] = 0
    mesh.bc_names = ["Cyc", "unused", "Wall"]
    return p, mesh, 0.02


def quad_rans_channel():
    return _walled(_rans_channel_input(), BCParams(name="Wall",
                                                   flag=ADIABAT_WALL))


def quad_wall_model():
    p = _rans_channel_input()
    p.RANS = 0
    p.LES, p.SGS_model, p.C_s = 1, 0, 0.1
    p.wall_model = 1
    return _walled(p, BCParams(name="Wall", flag=ISOTHERM_WALL,
                               T_static=1.0, use_wm=1))


def tet_viscous_roem():
    p = tgv_input()
    p.riemann_solve_type = 2
    return p, periodic_tet_mesh(2, 2, 2), 0.02


def tri_sutherland_hllc():
    return (vortex_deck(fix_vis=0, c_sth=0.368, mu_inf=1e-2), tri_box(),
            0.02)


def quad_les_smagorinsky():
    return (vortex_deck(LES=1, SGS_model=0, C_s=0.1, mu_inf=1e-2),
            quad_box(), 0.02)


def tet_les_smagorinsky():
    p = tgv_input()
    p.order, p.LES, p.SGS_model, p.C_s = 2, 1, 0, 0.1
    return p, periodic_tet_mesh(2, 2, 2), 0.02


def tet_over_int():
    p = RunInput.from_deck(os.path.join(DECKS, "input_tet_overint_25"))
    return p, periodic_tet_mesh(2, 2, 2), 0.02


def quad_les_wale_similarity():
    return (vortex_deck(LES=1, SGS_model=2, C_s=0.1, mu_inf=1e-2),
            quad_box(), 0.02)


RESIDUAL_CASES = {
    "tet_viscous_roem": tet_viscous_roem,
    "quad_channel_boundaries": quad_channel_boundaries,
    "quad_rans_channel": quad_rans_channel,
    "quad_wall_model": quad_wall_model,
    "tri_sutherland_hllc": tri_sutherland_hllc,
    "quad_les_smagorinsky": quad_les_smagorinsky,
    "tet_les_smagorinsky": tet_les_smagorinsky,
    "tet_over_int": tet_over_int,
    "quad_les_wale_similarity": quad_les_wale_similarity,
}


def _pair(p, mesh):
    """The JAX Solver and the port's (CPU) Solver of one deck and mesh."""
    return (JaxSolver(p, mesh),
            hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                     device="cpu"))


@pytest.mark.parametrize("compress", [True, False],
                         ids=["compressed", "full_geometry"])
@pytest.mark.parametrize("case", sorted(RESIDUAL_CASES))
def test_residual_matches_jax(case, compress, monkeypatch):
    if not compress:
        monkeypatch.setenv("HIFILES_NO_GEO_COMPRESS", "1")
    p, mesh, amp = RESIDUAL_CASES[case]()
    js, ts = _pair(p, mesh)
    assert js.n_dims == ts.n_dims and ts.ops.ele_type == int(mesh.ctype[0])
    u = np.asarray(js.u)
    rng = np.random.default_rng(0)
    u = np.ascontiguousarray(
        (u * (1.0 + amp * rng.random(u.shape))).transpose(1, 2, 0))
    if p.RANS:
        u[:, -1] = np.abs(u[:, -1]) + p.mu_inf
    jfn = jrs.make_residual_soa(js.block, js.rcfg, jnp.float64, js._bc_fns)
    assert jfn is not None
    want = np.asarray(jfn(jnp.asarray(u)))
    got = ts.residual_soa(torch.as_tensor(u)).numpy()
    scale = np.abs(want).max()
    assert np.isfinite(got).all()
    assert np.abs(want - got).max() < 1e-10 * max(scale, 1.0), \
        np.abs(want - got).max()


STEP_CASES = {
    "quad_vortex": lambda: (vortex_deck(), quad_box()),
    "tri_vortex": lambda: (vortex_deck(), tri_box()),
    "tet_tgv": lambda: (tgv_input(), periodic_tet_mesh(2, 2, 2)),
    "quad_shock_capture": lambda: (vortex_deck(shock_cap=1, s0=0.0,
                                               riemann_solve_type=2),
                                   quad_box()),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_solver_steps_match_jax(case):
    """A few Solver.run steps (RK45, and the shock-capture post-stage on
    every RK stage of the quad case): the states agree to 1e-10, and so do
    the volume-cubature errors against the isentropic vortex."""
    p, mesh = STEP_CASES[case]()
    js, ts = _pair(p, mesh)
    js.run(3, dt=p.dt)
    ts.run(3, dt=p.dt)
    a, b = np.asarray(js.u), ts.u
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() < 1e-10 * max(np.abs(a).max(), 1.0), \
        np.abs(a - b).max()
    js.p.test_case = ts.p.test_case = 1
    e_j, e_t = js.compute_error(2), ts.compute_error(2)
    assert np.all(e_j[0] > 0)
    assert np.all(np.abs(e_t - e_j) <= 1e-10 * np.abs(e_j))


@pytest.mark.parametrize("ctype", ["quad", "tri", "tet"])
def test_shock_capture_operator_matches_jax(ctype):
    """The Persson sensor and exponential filter on quad, tri and tet
    blocks, with s0 between the elements' sensor values so both branches
    run."""
    p, mesh = {"quad": (vortex_deck(), quad_box()),
               "tri": (vortex_deck(), tri_box()),
               "tet": (tgv_input(), periodic_tet_mesh(2, 2, 2))}[ctype]
    js, ts = _pair(p, mesh)
    rng = np.random.default_rng(3)
    u = np.asarray(js.u).transpose(1, 2, 0)
    u = np.ascontiguousarray(u * (1.0 + 0.05 * rng.random(u.shape)))
    args = (1.0, 16, 2, 0, ts.n_dims)
    # the density sensor's median as s0: half the elements are filtered
    modal = np.einsum("mu,ue->me", ts.ops.inv_vandermonde, u[:, 0])
    e2 = modal * modal * ts.ops.modal_norms[:, None]
    sensor = (e2 * persson_top_mode_mask(ts.ops)[:, None]).sum(0) / e2.sum(0)
    s0 = float(np.median(sensor))
    want = np.asarray(jax_capture(js.ops, s0, *args, jnp.float64)(
        jnp.asarray(u)))
    got = make_shock_capture_soa(ts.ops, s0, *args, "cpu", torch.float64)(
        torch.as_tensor(u.copy())).numpy()
    filtered = np.abs(want - u).max(axis=(0, 1)) > 0
    assert 0 < filtered.sum() < filtered.size
    assert np.abs(want - got).max() < 1e-12 * np.abs(want).max()


def test_vortex_l2_matches_reference_golden():
    """The reference binary's isentropic-vortex L2 error row (16^2 quads,
    p=3, 100 steps, f64; VORTEX_L2_GOLD) from the port on the CPU."""
    p = RunInput.from_deck(os.path.join(DECKS, "input_vortex_parity"))
    s = hifiles_tpu_torch.Solver(
        run_input_from(p), mesh_from(periodic_quad_mesh(16, 16, -5, 5, -5, 5)),
        device="cpu")
    s.run(p.n_steps, dt=p.dt)
    err = np.sqrt(s.compute_error(2)[0])
    assert np.abs(err - np.asarray(VORTEX_L2_GOLD)).max() < 1e-10, \
        (list(err), VORTEX_L2_GOLD)


def test_tet_over_int_matches_reference_golden():
    """Periodic 3^3 tet box, p=3, over-integration: the L1 row of the last
    RK stage after 25 steps against TET_OVERINT_GOLD, at the JAX test's
    tolerance 2e-4 * max(0.05, gold)."""
    p = RunInput.from_deck(os.path.join(DECKS, "input_tet_overint_25"))
    s = hifiles_tpu_torch.Solver(run_input_from(p),
                                 mesh_from(periodic_tet_mesh(3, 3, 3)),
                                 device="cpu")
    res = s.residual_norm(1, last_stage_residual(s, 25, p.dt))
    gold = np.asarray(TET_OVERINT_GOLD)
    assert np.all(np.abs(res - gold) < 2e-4 * np.maximum(0.05, gold)), \
        (list(res), TET_OVERINT_GOLD)


def test_prism_and_mixed_blocks_raise():
    """Prisms (non-uniform faces) and mixed meshes go to MixedSolver in the
    JAX package; the port's Solver names what is missing."""
    from hifiles_tpu.mesh.generate import (periodic_mixed_mesh_2d,
                                           periodic_prism_mesh)
    with pytest.raises(NotImplementedError, match="prism"):
        hifiles_tpu_torch.Solver(run_input_from(tgv_input()),
                                 mesh_from(periodic_prism_mesh(2, 2, 2)),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="mixed element types"):
        hifiles_tpu_torch.Solver(run_input_from(vortex_deck()),
                                 mesh_from(periodic_mixed_mesh_2d(4, 4)),
                                 device="cpu")


def quad_duct_mesh(nx=4, ny=3):
    """periodic_quad_mesh(nx, ny) with its x- faces (local face 3) in group
    1 ("Inflow") and its x+ faces (local face 1) in group 2 ("Outflow");
    y stays cyclic."""
    mesh = periodic_quad_mesh(nx, ny)
    for c in range(mesh.n_cells):
        if c % nx == 0:
            mesh.bc_id[c, 3] = 1
        if c % nx == nx - 1:
            mesh.bc_id[c, 1] = 2
    mesh.bc_names = ["Cyclic", "Inflow", "Outflow"]
    return mesh


# boundary flags at d = 2: the walls of the hex channel cases of
# tests/test_torch_boundaries.py on the walled quad channel, and its duct
# inflow/outflow pairs on the quad duct (case -> (kind, arguments))
BOUNDARY_2D = {
    "adiabat": ("wall", dict(flag=ADIABAT_WALL)),
    "isotherm": ("wall", dict(flag=ISOTHERM_WALL)),
    "slip": ("wall", dict(flag=SLIP_WALL)),
    "slip_dual_roem": ("wall", dict(flag=SLIP_WALL_DUAL, riemann=2)),
    "adiabat_wm2": ("wall", dict(flag=ADIABAT_WALL, wall_model=2)),
    "isotherm_wm2_les": ("wall", dict(flag=ISOTHERM_WALL, wall_model=2,
                                      les=1)),
    "duct_sub_char": ("duct", dict(pair="sub_char")),
    "duct_sup": ("duct", dict(pair="sup")),
    "duct_char_rusanov": ("duct", dict(pair="char", riemann=0)),
    "duct_ramp_lin": ("duct", dict(pair="ramp_lin", ramp=3.0)),
}


@pytest.mark.parametrize("case", sorted(BOUNDARY_2D))
def test_boundary_2d_matches_jax(case):
    """solver/bc.py and models/wall_model.py at d = 2 against the JAX
    package, on the TGV deck's scales with a uniform initial state."""
    from test_torch_boundaries import DUCT, wall_bc
    from test_torch_features import deck
    kind, a = BOUNDARY_2D[case]
    p = deck(order=2, ic_form=1, LES=a.get("les", 0))
    p.riemann_solve_type = a.get("riemann", 3)
    if kind == "wall":
        p.wall_model = a.get("wall_model", 0)
        p, mesh, _ = _walled(p, wall_bc(a["flag"], int(p.wall_model > 0)))
        p.dx_cyclic = 4.0
    else:
        p.bc_list = [BCParams(name="Cyclic", flag=CYCLIC), *DUCT[a["pair"]]]
        mesh = quad_duct_mesh()
        p.dy_cyclic = 2.0
    js, ts = _pair(p, mesh)
    assert ts.n_dims == 2 and ts.block.bdy_slot.size
    ramp = a.get("ramp")
    u = np.asarray(js.u)
    rng = np.random.default_rng(1)
    u = np.ascontiguousarray(
        (u * (1.0 + 0.02 * rng.random(u.shape))).transpose(1, 2, 0))
    jfn = jrs.make_residual_soa(js.block, js.rcfg, jnp.float64, js._bc_fns)
    want = np.asarray(jfn(jnp.asarray(u), ramp=None if ramp is None
                          else jnp.asarray(ramp)))
    got = ts.residual_soa(torch.as_tensor(u), ramp=None if ramp is None
                          else torch.tensor(ramp, dtype=torch.float64))
    got = got.numpy()
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 0
    assert np.abs(want - got).max() < 1e-10 * max(scale, 1.0), \
        np.abs(want - got).max()
