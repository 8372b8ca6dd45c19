"""Turbulent inlets in the PyTorch port (hifiles_tpu_torch): white noise and
the synthetic eddy method (SEM) against the JAX package at f64 on the CPU.

The port takes its random draws from a draw object; these tests replay the
JAX inlet's own key chain (turb_inlet.py:241-242, :258-265 of the JAX
package, from PRNGKey(seed)) through turb_inlet.ReplayDraws, so the port
computes what JAX computes from the same numbers: the host setup field by
field, one update of the fluctuations and eddies at 1e-12, and 5 solver
steps (Solver in 2-D and 3-D, MixedSolver) with states at 1e-10, eddy
positions at 1e-12 and equal signs.  Then the checks of
tests/test_turb_inlet.py on the port, the SEM restart file against the
JAX writer's bytes, and snapshot/restore."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hifiles_tpu.config.params import CYCLIC
from hifiles_tpu.io import restart as jax_restart
from hifiles_tpu.mesh.generate import (channel_mixed_mesh_2d,
                                       channel_quad_mesh, periodic_hex_mesh)
from hifiles_tpu.solver import multiblock as jax_multiblock
from hifiles_tpu.solver import turb_inlet as jax_ti
from hifiles_tpu.solver.multiblock import MixedSolver as JaxMixedSolver
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.io import restart as port_restart
from hifiles_tpu_torch.solver import multiblock as port_multiblock
from hifiles_tpu_torch.solver import turb_inlet as port_ti

sys.path.insert(0, os.path.dirname(__file__))
from test_turb_inlet import les_channel_input  # noqa: E402

torch.set_num_threads(1)


def channel_2d(inlet_type=2, n_eddy=40, mode=0):
    """tests/test_turb_inlet.py's deck and channel_quad_mesh(8, 4)."""
    return (les_channel_input(inlet_type=inlet_type, n_eddy=n_eddy,
                              mode=mode),
            channel_quad_mesh(8, 4, 0.0, 2.0, 0.0, 1.0))


def duct_3d(inlet_type=2, n_eddy=40, n=2):
    """The same deck on the n^3 hex box [-pi, pi]^3 with its x- faces
    "Inflow" and its x+ faces "Outflow", cyclic in y and z.  For odd n an
    inlet point lies on the generator axis (y = z = 0), where the three
    theta-images of an eddy are equidistant: the nearest is a tie, which
    the JAX package's jitted update breaks unlike its eager one (4e-5 of
    2.8e-2 on 3^3, p=2); the port breaks it as the eager one does."""
    p = les_channel_input(inlet_type=inlet_type, n_eddy=n_eddy)
    inflow, outflow, cyc = p.bc_list
    p.bc_list = [cyc, inflow, outflow]
    p.dy_cyclic = p.dz_cyclic = 2 * np.pi
    mesh = periodic_hex_mesh(n, n, n)
    for c in range(mesh.n_cells):
        if c % n == 0:
            mesh.bc_id[c, 4] = 1
        if c % n == n - 1:
            mesh.bc_id[c, 2] = 2
    mesh.bc_names = ["Cyclic", "Inflow", "Outflow"]
    return p, mesh


def mixed_2d(inlet_type=2, n_eddy=8):
    """The deck on the tri+quad channel_mixed_mesh_2d(4, 2)."""
    return (les_channel_input(inlet_type=inlet_type, n_eddy=n_eddy),
            channel_mixed_mesh_2d(4, 2, 0.0, 2.0, 0.0, 1.0))


CASES = {
    "sem_2d": (channel_2d, {}),
    "sem_2d_mode1": (channel_2d, dict(mode=1)),
    "white_noise_2d": (channel_2d, dict(inlet_type=1)),
    "sem_3d": (duct_3d, {}),
    "sem_3d_axis": (duct_3d, dict(n=3)),
    "white_noise_3d": (duct_3d, dict(inlet_type=1)),
    "sem_mixed": (mixed_2d, {}),
}


def jax_draws(ti, shape, n_steps, dtype=jnp.float64):
    """The JAX inlet's draws over n_steps from its initial key: one normal
    ``shape`` per step (white noise), or two uniforms (n_eddy, 3) (SEM)."""
    key = ti.init_state[2]
    out = []
    for _ in range(n_steps):
        if ti.inlet_type == 1:
            key, sub = jax.random.split(key)
            out.append(np.asarray(jax.random.normal(sub, shape, dtype=dtype)))
        else:
            key, k1, k2 = jax.random.split(key, 3)
            out += [np.asarray(jax.random.uniform(k, (ti.n_eddy, 3),
                                                  dtype=dtype))
                    for k in (k1, k2)]
    return out


def pair(case, n_steps):
    """The JAX solver and the port's (CPU), the port replaying the JAX
    inlet's draws for n_steps."""
    make, kw = CASES[case]
    p, mesh = make(**kw)
    mixed = case.endswith("mixed")
    js = (JaxMixedSolver if mixed else JaxSolver)(p, mesh)
    shape = None
    if js.turb_inlet.inlet_type == 1:
        n_in = js.turb_inlet.in_faces.size
        nfp = js.mt.bdy_slot.shape[1] if mixed else js.block.bdy_slot.shape[1]
        shape = (n_in, nfp, js.n_dims)
    draws = port_ti.ReplayDraws(jax_draws(js.turb_inlet, shape, n_steps),
                                "cpu", torch.float64)
    ts = (hifiles_tpu_torch.MixedSolver if mixed else hifiles_tpu_torch.Solver)(
        run_input_from(p), mesh_from(mesh), device="cpu")
    ts.set_inlet_draws(draws)
    return js, ts


@pytest.mark.parametrize("case", ["sem_2d", "sem_3d", "sem_mixed"])
def test_inlet_host_setup_identical(case):
    """inlet_host_setup field by field, on a block and (mixed) on the
    _TIFacade of the global slot space, the facade's tables too."""
    js, ts = pair(case, 0)
    if case.endswith("mixed"):
        fj = jax_multiblock._TIFacade(js.mt, js.p)
        ft = port_multiblock._TIFacade(ts.mt, ts.p)
        for name in ("slot_wq", "slot_ls"):
            assert np.array_equal(getattr(fj, name), getattr(ft, name))
    else:
        fj, ft = js.block, ts.block
    cj = jax_ti.inlet_host_setup(js.p, fj, seed=3)
    ct = port_ti.inlet_host_setup(ts.p, ft, seed=3)
    assert vars(cj).keys() == vars(ct).keys()
    for k, a in vars(cj).items():
        b = getattr(ct, k)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        else:
            assert a == b, k
    assert ct.in_faces.size > 0


@pytest.mark.parametrize("case", ["sem_2d", "sem_2d_mode1", "white_noise_2d",
                                  "sem_3d", "sem_3d_axis", "white_noise_3d"])
def test_fluc_core_step_matches_jax(case):
    """One inlet update (the JAX one eager) from a perturbed state and the
    same draws: the fluctuations on the boundary planes and the new eddies
    at 1e-12, the tie on the generator axis included (sem_3d_axis)."""
    js, ts = pair(case, 1)
    rng = np.random.default_rng(1)
    u = np.asarray(js.u) * (1.0 + 0.01 * rng.random(np.asarray(js.u).shape))
    disu_f = np.einsum("pu,euf->epf", js.ops.opp_0, u).reshape(-1,
                                                                js.n_fields)
    state, fl = js.turb_inlet.update(js.turb_inlet.init_state,
                                     jnp.asarray(disu_f[js.block.bdy_slot]),
                                     1e-5)
    uf2 = ts.residual_soa.flux_point_rows(
        torch.as_tensor(np.ascontiguousarray(u.transpose(1, 2, 0))))
    state_t, fl_t = ts.turb_inlet.update(ts._ti_state, uf2, 1e-5)
    want = np.transpose(np.asarray(fl), (2, 1, 0))       # (d, nfp, Fb)
    scale = np.abs(want).max()
    assert scale > 0 and fl_t.shape == want.shape
    assert np.abs(fl_t.numpy() - want).max() < 1e-12 * max(scale, 1.0)
    assert np.abs(state_t[0].numpy() - np.asarray(state[0])).max() < 1e-12
    assert np.array_equal(state_t[1].numpy(), np.asarray(state[1]))


@pytest.mark.parametrize("case", ["sem_2d", "white_noise_2d", "sem_3d",
                                  "white_noise_3d", "sem_mixed"])
def test_solver_steps_match_jax(case):
    """5 steps (RK45) of the inlet-fed solver: states at 1e-10, eddy
    positions at 1e-12, signs equal."""
    js, ts = pair(case, 5)
    js.run(5, dt=1e-5)
    ts.run(5, dt=1e-5)
    for a, b in zip(js.u if isinstance(js.u, tuple) else (js.u,),
                    ts.u if isinstance(ts.u, tuple) else (ts.u,)):
        a = np.asarray(a)
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() < 1e-10 * max(np.abs(a).max(), 1.0)
    assert np.abs(ts._ti_state[0].numpy()
                  - np.asarray(js._ti_state[0])).max() < 1e-12
    assert np.array_equal(ts._ti_state[1].numpy(),
                          np.asarray(js._ti_state[1]))
    assert ts._ti_state[2].get_state() == len(ts._ti_state[2].arrays)


def port_solver(make, **kw):
    p, mesh = make(**kw)
    return hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                    device="cpu")


def test_sem_inlet_runs_and_perturbs():
    """tests/test_turb_inlet.py:56-75 on the port, with the default draws
    (a torch.Generator seeded with 0): a stable run whose momentum differs
    from the laminar (inlet_type 0) run by a small fluctuation."""
    s_sem = port_solver(channel_2d)
    assert isinstance(s_sem._ti_state[2], port_ti.DeviceDraws)
    assert s_sem.turb_inlet.inlet_type == 2
    s_sem.run(50, dt=1e-5)
    s_lam = port_solver(channel_2d, inlet_type=0)
    assert s_lam.turb_inlet is None
    s_lam.run(50, dt=1e-5)
    assert np.isfinite(s_sem.u).all()
    diff = np.abs(s_sem.u[..., 1] - s_lam.u[..., 1]).max()
    assert 1e-8 < diff < 0.5 * abs(s_sem.p.u_c_ic), diff


def test_sem_mass_flux_correction():
    """tests/test_turb_inlet.py:84-106 on the port: the fluctuations carry
    zero net mass flux through the inlet, from the inlet's own rows and
    recomputed from the block's tables."""
    s = port_solver(channel_2d)
    ti = s.turb_inlet
    _, fluc = ti.update(s._ti_state,
                        s.residual_soa.flux_point_rows(s.u_soa), 1e-5)
    fl = fluc.numpy().transpose(2, 1, 0)                 # (Fb, nfp, d)
    assert np.isfinite(fl).all() and np.abs(fl).max() > 0
    slots = s.block.bdy_slot[ti.in_faces]
    mask = s.block.bdy_mask[ti.in_faces]
    wdA = s.ops.fpt_weights[slots % s.ops.n_fpts] * s.block.tdA_fpts[slots] \
        * mask
    mf = float(np.sum(wdA * fl[ti.in_faces][..., 0] * s.p.rho_c_ic))
    assert abs(mf) / wdA.sum() < 1e-12, mf
    mf_t, scale = ti.mass_flux()
    assert mf_t < 1e-12 * scale


def test_sem_eddies_recycle():
    """tests/test_turb_inlet.py:109-118 on the port: eddies advected out
    of the box re-enter, positions stay bounded."""
    s = port_solver(channel_2d, n_eddy=20)
    start = s._ti_state[0].clone()
    s.run(100, dt=1e-4)
    pos = s._ti_state[0].numpy()
    assert np.isfinite(pos).all() and np.abs(pos).max() < 5.0
    assert not np.array_equal(pos, start.numpy())


def test_sem_restart_matches_jax_writer(tmp_path):
    """write_sem_restart writes the JAX writer's bytes for the same eddies
    and signs; read_sem_restart loads them back (tests/test_io_extras.py:
    117-133)."""
    js, ts = pair("sem_2d", 5)
    js.run(5, dt=1e-5)
    ts.run(5, dt=1e-5)
    state = (ts._ti_state[0].numpy(), ts._ti_state[1].numpy(), None)
    a = jax_restart.write_sem_restart(str(tmp_path / "jax"), 5,
                                      js.turb_inlet, state, js.p)
    b = port_restart.write_sem_restart(str(tmp_path / "port"), 5,
                                       ts.turb_inlet, ts._ti_state, ts.p)
    assert os.path.relpath(a, tmp_path / "jax") == \
        os.path.relpath(b, tmp_path / "port")
    assert open(a, "rb").read() == open(b, "rb").read()
    s2 = port_solver(channel_2d)
    draws = s2._ti_state[2]
    assert port_restart.read_sem_restart(str(tmp_path / "port"), 5, s2)
    assert s2._ti_state[2] is draws
    assert np.abs(s2._ti_state[0].numpy() - state[0]).max() < 1e-10
    assert np.array_equal(s2._ti_state[1].numpy(), state[1])
    assert not port_restart.read_sem_restart(str(tmp_path / "port"), 99, s2)


@pytest.mark.parametrize("case", ["sem_2d", "white_noise_2d"])
def test_snapshot_restore(case):
    """restore(snapshot()) replays a run exactly, the inlet's eddies and
    its draw generator's state included."""
    make, kw = CASES[case]
    s = port_solver(make, **kw)
    s.run(2, dt=1e-5)
    snap = s.snapshot()
    s.run(3, dt=1e-5)
    u1, pos1 = s.u.copy(), s._ti_state[0].clone()
    s.restore(snap)
    s.run(3, dt=1e-5)
    assert np.array_equal(s.u, u1)
    assert torch.equal(s._ti_state[0], pos1)
    assert s.time == pytest.approx(5e-5)


def test_cyclic_groups_have_no_inlet():
    """A deck whose only turbulent group is not an inflow flag builds no
    inlet (inlet_host_setup's condition)."""
    p, mesh = channel_2d(inlet_type=2)
    p.bc_list[0].flag = CYCLIC
    p.bc_list[0].inlet_type = 2
    assert port_ti.inlet_host_setup(run_input_from(p), None) is None


def sem_deck(tmp_path):
    """tests/decks/input_channel_les_bench turned into a 2-step WALE LES
    channel with a 20-eddy SEM inflow and a restart dump at step 2, on
    channel_quad_mesh(8, 4) written as a Gambit file."""
    from hifiles_tpu.mesh.gambit import write_gambit
    write_gambit(channel_quad_mesh(8, 4, 0.0, 2.0, 0.0, 1.0),
                 str(tmp_path / "channel.neu"))
    text = open(os.path.join(os.path.dirname(__file__), "decks",
                             "input_channel_les_bench")).read()
    u = float(0.2 * np.sqrt(1.4 * 286.9 * 300.0))
    for old, new in (("order      4", "order      2"),
                     ("n_steps    100", "n_steps    2"),
                     ("channel_hex.neu", "channel.neu"),
                     ("dx_cyclic    6.283185307179586", "dy_cyclic 1.0"),
                     ("dz_cyclic    3.141592653589793", ""),
                     ("restart_dump_freq  100000", "restart_dump_freq  2"),
                     ("average_fields  5 rho_average u_average v_average "
                      "w_average e_average", ""),
                     ("body_forcing     1", "body_forcing     0"),
                     ("SGS_model     0", "SGS_model     1"),
                     ("C_s           0.1", "C_s           0.5"),
                     ("bc_Wall_type adiabat_wall",
                      "bc_Inflow_type sub_in_simp\nbc_Inflow_rho 1.17723946\n"
                      f"bc_Inflow_u {u!r}\nbc_Inflow_v 0.\nbc_Inflow_w 0.\n"
                      "bc_Inflow_inlet_type 2\n"
                      f"bc_Inflow_turb_1 {(0.01 * u) ** 2!r}\n"
                      "bc_Inflow_turb_2 10.\nbc_Inflow_n_eddy 20\n"
                      "bc_Outflow_type sub_out_simp\n"
                      f"bc_Outflow_p_static {1.17723946 * 286.9 * 300.0!r}\n"
                      "bc_Outflow_T_total 300.\n")):
        assert old in text, old
        text = text.replace(old, new)
    (tmp_path / "run.deck").write_text(text)
    return tmp_path / "run.deck"


def test_driver_dumps_sem_restart(tmp_path, capsys):
    """Both drivers dump the SEM eddies at the restart dump
    (driver.py:231-235 of the JAX package): the same file, with the same
    header (mode, vis_y, turb_1 turb_2, n_eddy) and shape; the eddies
    themselves follow each package's own draws."""
    from hifiles_tpu import driver as jax_driver
    from hifiles_tpu_torch import driver as port_driver
    deck = sem_deck(tmp_path)
    assert jax_driver.main([str(deck), "--f64", "--outdir",
                            str(tmp_path / "jax")]) == 0
    assert port_driver.main([str(deck), "--f64", "--device", "cpu",
                             "--outdir", str(tmp_path / "port")]) == 0
    rel = os.path.join("sem_files", "sem_files_000000002.dat")
    a = (tmp_path / "jax" / rel).read_text().splitlines()
    b = (tmp_path / "port" / rel).read_text().splitlines()
    assert a[:4] == b[:4] and a[3] == "20" and len(a) == len(b) == 4 + 40
    eddies = np.array([r.split() for r in b[4:24]], dtype=float)
    assert np.isfinite(eddies).all()
    assert set(np.array([r.split() for r in b[24:]], int).ravel()) <= {-1, 1}
