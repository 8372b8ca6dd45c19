"""Advection-diffusion (equation 1) in the PyTorch port (hifiles_tpu_torch):
the scalar volume flux, the Lax-Friedrichs interface flux, the scalar LDG
diffusive flux and AD_WALL, against the JAX package at f64 on the CPU.

Residuals are held against the JAX make_residual_soa and
make_mixed_residual_soa at 1e-10 * max(scale, 1) (tests/test_residual_soa.py:
29-36), with geometry compression on and off; the cases of
tests/test_adv_diff.py run through both packages to the same error rows;
one deck runs through both drivers."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.config.params import AD_WALL, CYCLIC, BCParams
from hifiles_tpu.mesh.gambit import write_gambit
from hifiles_tpu.mesh.generate import (channel_quad_mesh, periodic_hex_mesh,
                                       periodic_mixed_mesh_2d,
                                       periodic_quad_mesh, periodic_tet_mesh)
from hifiles_tpu.solver import residual_soa as jrs
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch import driver as port_driver
from hifiles_tpu_torch.convert import mesh_from, run_input_from

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from chip_smoke import periodic_tri_mesh  # noqa: E402
from test_adv_diff import adv_diff_input  # noqa: E402
from test_torch_driver import assert_close, table  # noqa: E402
from test_torch_mixed import pair, perturbed  # noqa: E402

torch.set_num_threads(1)


def deck(order=2, over_int=False, **attrs):
    """tests/test_adv_diff.py's deck (LF, LDG beta 0.5, tau 1) at
    ``order``, with over-integration at order + 2 if asked."""
    p = adv_diff_input(order=order)
    if over_int:
        p.over_int, p.over_int_order = 1, order + 2
    for k, v in attrs.items():
        setattr(p, k, v)
    return p


def deck_3d(order=2, over_int=False):
    return deck(order, over_int, dz_cyclic=2.0, wave_speed=(1.0, 0.5, 0.25))


def ad_wall_channel():
    """The sine wave in the x-periodic channel_quad_mesh(8, 4) on
    [0, 2] x [0, 1] with AD_WALL at y = 0 and y = 1."""
    p = deck(order=2)
    p.bc_list = [BCParams(name="Cyc", flag=CYCLIC),
                 BCParams(name="CycX", flag=CYCLIC),
                 BCParams(name="Wall", flag=AD_WALL)]
    mesh = channel_quad_mesh(8, 4, 0.0, 2.0, 0.0, 1.0, bc_x="Cyc",
                             bc_X="Cyc", bc_y="Wall")
    mesh.bc_id[mesh.bc_id == 1] = 0
    mesh.bc_names = ["Cyc", "unused", "Wall"]
    return p, mesh


box2 = lambda: periodic_quad_mesh(4, 4, -1, 1, -1, 1)
tri2 = lambda: periodic_tri_mesh(3, 3, -1, 1, -1, 1)
box3 = lambda: periodic_hex_mesh(3, 3, 3, -1, 1, -1, 1, -1, 1)
tet3 = lambda: periodic_tet_mesh(2, 2, 2, -1, 1, -1, 1, -1, 1)

RESIDUAL_CASES = {
    "quad": lambda: (deck(order=3), box2()),
    "quad_over_int": lambda: (deck(order=2, over_int=True), box2()),
    "tri": lambda: (deck(order=3), tri2()),
    "tri_over_int": lambda: (deck(order=2, over_int=True), tri2()),
    "hex": lambda: (deck_3d(), box3()),
    "hex_over_int": lambda: (deck_3d(over_int=True), box3()),
    "tet": lambda: (deck_3d(), tet3()),
    "tet_over_int": lambda: (deck_3d(over_int=True), tet3()),
    "quad_ad_wall": ad_wall_channel,
}


def _pair(p, mesh):
    return (JaxSolver(p, mesh),
            hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                     device="cpu"))


@pytest.mark.parametrize("compress", [True, False],
                         ids=["compressed", "full_geometry"])
@pytest.mark.parametrize("case", sorted(RESIDUAL_CASES))
def test_residual_matches_jax(case, compress, monkeypatch):
    """The equation-1 residual of a perturbed sine wave against the JAX
    make_residual_soa; the port runs no volume kernel for it."""
    if not compress:
        monkeypatch.setenv("HIFILES_NO_GEO_COMPRESS", "1")
    p, mesh = RESIDUAL_CASES[case]()
    js, ts = _pair(p, mesh)
    assert ts.n_fields == 1 and ts.rcfg.wave_speed == tuple(p.wave_speed)
    if case == "quad_ad_wall":
        assert ts._bc_fns is not None and AD_WALL in ts._bc_fns.flags
    rng = np.random.default_rng(0)
    u = np.asarray(js.u)
    u = np.ascontiguousarray(
        (u + 0.05 * rng.standard_normal(u.shape)).transpose(1, 2, 0))
    jfn = jrs.make_residual_soa(js.block, js.rcfg, jnp.float64, js._bc_fns)
    want = np.asarray(jfn(jnp.asarray(u)))
    got = ts.residual_soa(torch.as_tensor(u)).numpy()
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 0
    assert np.abs(want - got).max() < 1e-10 * max(scale, 1.0), \
        np.abs(want - got).max()


@pytest.mark.parametrize("over_int", [False, True], ids=["plain", "over_int"])
def test_mixed_residual_matches_jax(over_int):
    """The tri+quad box through MixedSolver against the JAX
    make_mixed_residual_soa."""
    p = deck(order=2, over_int=over_int)
    js, ts = pair(p, periodic_mixed_mesh_2d(3, 3, -1, 1, -1, 1))
    u = perturbed(js)
    want = js.residual_soa(tuple(jnp.asarray(a.transpose(1, 2, 0))
                                 for a in u))
    got = ts.residual_soa(tuple(torch.as_tensor(
        np.ascontiguousarray(a.transpose(1, 2, 0))) for a in u))
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.numpy()
        scale = np.abs(a).max()
        assert b.shape == a.shape and scale > 0
        assert np.abs(a - b).max() < 1e-10 * max(scale, 1.0)


def test_ad_wall_ghost_state_is_zero():
    """Under equation 1 every boundary ghost state is zero, whatever the
    flag (bc.py:130-132 of the JAX package), and so is AD_WALL's own
    candidate under equation 0 (:309-310)."""
    p, mesh = ad_wall_channel()
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    bc = ts._bc_fns
    u = [torch.rand((3, bc.P["rho"].shape[1]), dtype=torch.float64) + 1.0]
    norm = [torch.ones_like(u[0]), torch.zeros_like(u[0])]
    for sol_spec in (0, 1, 2):
        assert all(float(x.abs().max()) == 0.0
                   for x in bc.ghost_state(u, norm, sol_spec))


def _errors(s, steps, dt):
    s.run(steps, dt=dt)
    return np.asarray(s.compute_error(norm_type=2))


# the cases of tests/test_adv_diff.py (deck, mesh, steps, dt); the tet
# convergence case on 2^3 and 3^3 tets, the others at that file's sizes
ERROR_CASES = {
    "sine_wave_beta0.5_tau1": lambda: (deck(order=3),
                                       periodic_quad_mesh(8, 8, -1, 1, -1, 1),
                                       100, 1e-3),
    "sine_wave_beta0_tau0.1": lambda: (
        deck(order=3, ldg_beta=0.0, ldg_tau=0.1),
        periodic_quad_mesh(8, 8, -1, 1, -1, 1), 100, 1e-3),
    "convergence_p2_n4": lambda: (deck(order=2, diff_coeff=0.02),
                                  periodic_quad_mesh(4, 4, -1, 1, -1, 1),
                                  50, 2e-3),
    "convergence_p2_n8": lambda: (deck(order=2, diff_coeff=0.02),
                                  periodic_quad_mesh(8, 8, -1, 1, -1, 1),
                                  100, 1e-3),
    "pure_diffusion": lambda: (deck(order=3, diff_coeff=0.1,
                                    wave_speed=(0.0, 0.0, 0.0)),
                               periodic_quad_mesh(8, 8, -1, 1, -1, 1), 100,
                               1e-3),
    "tet_gradient_n2": lambda: (
        deck(order=2, diff_coeff=0.02, dz_cyclic=2.0,
             wave_speed=(1.0, 0.5, 0.25)),
        periodic_tet_mesh(2, 2, 2, -1, 1, -1, 1, -1, 1), 12, 4e-3),
    "tet_gradient_n3": lambda: (
        deck(order=2, diff_coeff=0.02, dz_cyclic=2.0,
             wave_speed=(1.0, 0.5, 0.25)),
        periodic_tet_mesh(3, 3, 3, -1, 1, -1, 1, -1, 1), 18, 8e-3 / 3),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_rows_match_jax(case):
    """The solution and gradient error rows after the run, port against
    JAX; the sine-wave and diffusion bounds of tests/test_adv_diff.py
    hold on the port."""
    p, mesh, steps, dt = ERROR_CASES[case]()
    js, ts = _pair(p, mesh)
    u0 = ts.u.copy()
    want, got = _errors(js, steps, dt), _errors(ts, steps, dt)
    assert want[0, 0] > 0 and want[1, 0] > 0
    assert np.all(np.abs(got - want) <= 1e-10 * np.abs(want)), (got, want)
    if case.startswith("sine_wave"):
        assert np.sqrt(got[0, 0]) < 2e-4
    if case == "pure_diffusion":
        ratio = np.linalg.norm(ts.u) / np.linalg.norm(u0)
        assert abs(ratio - np.exp(-2 * 0.1 * np.pi**2 * 0.1)) < 1e-4


def test_compute_dt_refuses_cfl_steps():
    """dt_type 1 and 2 need |v| + c: the JAX Solver.compute_dt returns NaN
    on an equation-1 deck, the port raises naming it; dt_type 0 gives the
    deck's dt as before."""
    for dt_type in (1, 2):
        p = deck(order=2, dt_type=dt_type, CFL=0.5)
        js, ts = _pair(p, box2())
        assert np.isnan(np.asarray(js.compute_dt())).any()
        with pytest.raises(ValueError, match="NaN"):
            ts.compute_dt()
        ms = hifiles_tpu_torch.MixedSolver(
            run_input_from(p), mesh_from(periodic_mixed_mesh_2d(
                2, 2, -1, 1, -1, 1)), device="cpu")
        with pytest.raises(ValueError, match="equation 1"):
            ms.compute_dt()
    js, ts = _pair(deck(order=2), box2())
    assert ts.compute_dt() == js.compute_dt() == 1e-3


ADV_DIFF_DECK = """
equation 1
viscous 1
order 2
ic_form 2
test_case 2
n_steps 20
adv_type 3
riemann_solve_type 1
dt_type 0
dt 1e-3
vcjh_scheme_quad 1
wave_speed_x 1.0
wave_speed_y 0.5
diff_coeff 0.05
lambda 1.0
ldg_beta 0.5
ldg_tau 1.0
plot_freq 20
restart_dump_freq 0
monitor_res_freq 10
u_c_ic 0.
v_c_ic 0.
w_c_ic 0.
p_c_ic 0.
rho_c_ic 0.
mesh_file box.neu
dx_cyclic 2.0
dy_cyclic 2.0
bc_Cyclic_type Cyclic
"""


def test_driver_matches_jax(tmp_path):
    """The sine wave as a deck through ``python -m hifiles_tpu_torch``:
    its history rows (iterations 10 and 20) and error.dat (solution and
    gradient rows) against the rows the JAX driver computes, taken from
    the JAX Solver on the same deck and mesh.  The JAX driver itself
    stops at its first history row on any equation-1 deck: its
    io/history.py reads a pressure from the one field even with no
    integral asked, and its plot writers likewise read one in
    io/vtu.py's diagnostic_fields; the port's copies return early, so it
    also writes the vtu."""
    from hifiles_tpu.config.params import RunInput as JaxRunInput
    from hifiles_tpu.mesh.gambit import read_gambit
    write_gambit(periodic_quad_mesh(4, 4, -1, 1, -1, 1),
                 str(tmp_path / "box.neu"))
    (tmp_path / "run.deck").write_text(ADV_DIFF_DECK)
    assert port_driver.main([str(tmp_path / "run.deck"), "--f64", "--device",
                             "cpu", "--outdir", str(tmp_path / "port")]) == 0
    hist, _ = table(tmp_path / "port" / "history.plt", drop_last=True)
    p = JaxRunInput.from_deck(str(tmp_path / "run.deck"))
    js = JaxSolver(p, read_gambit(str(tmp_path / "box.neu")))
    want = []
    for _ in range(2):
        js.run(10, dt=p.dt)
        want.append([np.log10(r) for r in js.residual_norm(p.res_norm_type)]
                    + [js.time])
    assert [int(r[0]) for r in hist] == [10, 20]
    assert_close(np.array(hist, dtype=float)[:, 1:], want)
    err = np.sqrt(js.compute_error(2))
    assert_close(table(tmp_path / "port" / "error.dat")[0],
                 [list(err[0]) + list(err[1])])
    vtu = (tmp_path / "port" / "Mesh_000000020"
           / "Mesh_000000020_p0000.vtu").read_text()
    rho = vtu.split('Name="rho" format="ascii">')[1].split("<")[0].split()
    assert len(rho) == 16 * 4 and np.isfinite(np.array(rho, float)).all()
