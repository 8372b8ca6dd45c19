"""Element-sharded runs of one element type in the PyTorch port
(hifiles_tpu_torch.parallel.ShardedSolver) on the CPU, in f64: N shards on
one controller against the port's single-device Solver from the same
seeded state, for the cases of tests/test_soa_sharding.py,
test_sharding.py and test_sharded_bc.py, gather_u held to
1e-11 * max(scale, 1).  Where a case exercises what only the sharded
reference does (halo faces in 3-D with viscosity, unequal shards with
boundaries, the inflow mass flux and averages summed over shards, the
padded local dt and its minimum, the inlet's plane sums, the residual
norms) it is also held to the JAX package's ShardedSolver on the virtual
CPU devices of tests/conftest.py; the port's single-device solver is held
to the JAX one by the other test_torch_* files."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hifiles_tpu.config.params import (ADIABAT_WALL, BCParams, CYCLIC,
                                       SUB_IN_CHAR, RunInput)
from hifiles_tpu.mesh.generate import (channel_hex_mesh, channel_quad_mesh,
                                       periodic_hex_mesh,
                                       periodic_prism_mesh,
                                       periodic_quad_mesh, periodic_tet_mesh)
from hifiles_tpu.parallel.sharding import ShardedSolver as JaxShardedSolver

from hifiles_tpu_torch import Solver
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.parallel import ShardedSolver, select_devices
from hifiles_tpu_torch.solver.turb_inlet import ReplayDraws

sys.path.insert(0, os.path.dirname(__file__))
from test_face_path import tgv_input  # noqa: E402
from test_les import tgv_input as les_tgv  # noqa: E402
from test_mixed_wall_model import _channel_mesh, _wm_input  # noqa: E402
from test_rans_viscous_bc import _rans_channel_input  # noqa: E402
from test_sharded_bc import channel_input  # noqa: E402
from test_sharding import vortex_input  # noqa: E402
from test_torch_turb_inlet import duct_3d, jax_draws  # noqa: E402
from test_turb_inlet import les_channel_input  # noqa: E402

torch.set_num_threads(1)

DECKS = os.path.join(os.path.dirname(__file__), "decks")


def held(got, want, what=""):
    """|got - want| <= 1e-11 * max(scale, 1) entry by entry."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert got.shape == want.shape and np.isfinite(got).all(), what
    assert err <= 1e-11 * scale, (what, err, scale)


def _order2(make):
    def f():
        p = make()
        p.order = 2
        return p
    return f


def quad_channel_7():
    p = les_channel_input(inlet_type=0)
    p.LES = 0
    return p, channel_quad_mesh(10, 4, 0.0, 2.0, 0.0, 1.0)


def rans_channel():
    p = _rans_channel_input()
    p.bc_list = [BCParams(name="Cyc", flag=CYCLIC),
                 BCParams(name="CycX", flag=CYCLIC),
                 BCParams(name="Wall", flag=ADIABAT_WALL)]
    mesh = channel_quad_mesh(8, 4, 0.0, 4.0, 0.0, 1.0,
                             bc_x="Cyc", bc_X="Cyc", bc_y="Wall")
    mesh.bc_id[mesh.bc_id == 1] = 0
    mesh.bc_names = ["Cyc", "unused", "Wall"]
    return p, mesh


def ramped_channel():
    p = channel_input(0)
    p.bc_list[0] = BCParams(
        name="Inflow", flag=SUB_IN_CHAR, p_total=30.0, T_total=350.0,
        nx=1.0, ny=0.0, pressure_ramp=1, p_ramp_coeff=0.05,
        T_ramp_coeff=0.0, p_total_old=20.0, T_total_old=350.0)
    return p, channel_quad_mesh(8, 4, 0.0, 2.0, 0.0, 1.0)


def les_channel_bench(order=2, **attrs):
    p = RunInput.from_deck(os.path.join(DECKS, "input_channel_les_bench"))
    p.order = order
    for k, v in attrs.items():
        setattr(p, k, v)
    return p, channel_hex_mesh(4, 4, 2)


def hex_tgv(les=None, **attrs):
    p = tgv_input() if les is None else les_tgv(les=1, sgs_model=les)
    p.order = 2
    for k, v in attrs.items():
        setattr(p, k, v)
    return p, periodic_hex_mesh(4, 2, 2)


# name -> (deck and mesh, shards, steps, perturb the initial state)
CASES = {
    "hex_tgv_viscous": (lambda: (_order2(tgv_input)(),
                                 periodic_hex_mesh(4, 4, 4)), 8, 3, False),
    "quad_channel_7_shards": (quad_channel_7, 7, 3, False),
    "quad_vortex": (lambda: (vortex_input(2),
                             periodic_quad_mesh(8, 8, -5, 5, -5, 5)), 8, 5,
                    False),
    "les_smagorinsky": (lambda: hex_tgv(les=0), 8, 3, True),
    "les_wale": (lambda: hex_tgv(les=1), 8, 3, True),
    "les_similarity": (lambda: hex_tgv(les=4), 8, 3, True),
    "over_int": (lambda: hex_tgv(over_int=1, over_int_order=4), 8, 3, True),
    "shock_capture_roem": (lambda: hex_tgv(shock_cap=1, s0=0.0,
                                           riemann_solve_type=2), 8, 3,
                           True),
    "svv": (lambda: hex_tgv(les=3), 8, 3, True),
    "rans_channel": (rans_channel, 7, 3, True),
    "wall_model": (lambda: (_wm_input(), _channel_mesh()), 7, 3, True),
    "inflow_outflow_inviscid": (lambda: (channel_input(0), channel_quad_mesh(
        8, 4, 0.0, 2.0, 0.0, 1.0)), 4, 10, True),
    "inflow_outflow_viscous": (lambda: (channel_input(1), channel_quad_mesh(
        8, 4, 0.0, 2.0, 0.0, 1.0)), 4, 10, True),
    "pressure_ramp": (ramped_channel, 4, 6, False),
    "forced_les_channel": (les_channel_bench, 8, 4, False),
    "tet_tgv": (lambda: (_order2(tgv_input)(), periodic_tet_mesh(2, 2, 2)),
                4, 3, True),
}


def port_pair(p, mesh, n, perturb=False, seed=0, **kw):
    """The port's Solver and its ShardedSolver on ``n`` CPU shards from
    the same initial state (perturbed by 2% when asked)."""
    s1 = Solver(run_input_from(p), mesh_from(mesh), device="cpu")
    ss = ShardedSolver(run_input_from(p), mesh_from(mesh),
                       devices=select_devices(n, "cpu"), **kw)
    u = s1.u
    if perturb:
        rng = np.random.default_rng(seed)
        u = u * (1.0 + 0.02 * rng.random(u.shape))
        for s in (s1, ss):
            s.set_state(u, np.zeros_like(u), 0.0)
    return s1, ss, u


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_matches_single_device(case):
    """n shards on one controller == the single-device Solver after a few
    RK45 steps: the state (and, featured, the averages and the mass-flux
    memory)."""
    make, n, n_steps, perturb = CASES[case]
    p, mesh = make()
    s1, ss, _ = port_pair(p, mesh, n, perturb)
    assert ss.n_shards == n and len(ss._shard_res) == n
    assert sum(ss.sizes) == s1.block.n_eles and ss.dof == s1.dof
    for s in (s1, ss):
        s.run(n_steps, dt=p.dt)
    held(ss.gather_u(), s1.u, case)
    assert ss.u.shape == (n, ss.El) + s1.u.shape[1:]
    held(ss.u.reshape(-1, *s1.u.shape[1:])[ss.pad_mask.reshape(-1) > 0],
         s1.u[ss.owner.reshape(-1)[ss.pad_mask.reshape(-1) > 0]])
    if s1.u_avg is not None:
        held(ss.gather_u_avg(), s1.u_avg, case + " averages")
        assert abs(ss.mdot_old - s1.mdot_old) <= 1e-11 * max(
            abs(s1.mdot_old), 1.0)
    if case == "pressure_ramp":
        assert float(ss._k) == float(s1._k) == 1.0 + n_steps


def test_graph_partition_matches_single_device():
    """partition="graph" (spectral bisection + refinement) on 5 shards of
    the hex TGV: unequal, non-contiguous shards."""
    p, mesh = _order2(tgv_input)(), periodic_hex_mesh(4, 4, 2)
    s1, ss, _ = port_pair(p, mesh, 5, partition="graph")
    assert sorted(ss.sizes) == [6, 6, 6, 7, 7]
    for s in (s1, ss):
        s.run(3, dt=p.dt)
    held(ss.gather_u(), s1.u)


@pytest.mark.parametrize("geo", ["compressed", "per element"])
def test_sharded_viscous_geometry(monkeypatch, geo):
    """The viscous hex TGV in 3 shards with the shards' geometry
    compressed (a shard of a uniform box, E' = 1) and kept per element
    (HIFILES_NO_GEO_COMPRESS)."""
    if geo == "per element":
        monkeypatch.setenv("HIFILES_NO_GEO_COMPRESS", "1")
    p, mesh = _order2(tgv_input)(), periodic_hex_mesh(3, 3, 2)
    s1, ss, _ = port_pair(p, mesh, 3, perturb=True)
    for s in (s1, ss):
        s.run(2, dt=p.dt)
    held(ss.gather_u(), s1.u)


# ----------------------------------------------------------------------
# against the JAX package's ShardedSolver
# ----------------------------------------------------------------------

def jax_sharded(p, mesh, n, u=None):
    ss = JaxShardedSolver(p, mesh, devices=jax.devices()[:n],
                          dtype=jnp.float64)
    if u is not None:
        ss.u = jax.device_put(jnp.asarray(
            u[ss.owner.reshape(-1)].reshape(ss.u.shape), jnp.float64),
            ss.u.sharding)
    return ss


@pytest.mark.parametrize("case", ["hex_tgv_viscous", "quad_channel_7_shards",
                                  "tet_tgv"])
def test_sharded_matches_jax_sharded(case):
    """The halo path in 3-D with viscosity on 8 shards, 7 unequal shards
    with inflow/outflow boundaries, and tets, whose tri faces turn between
    a halo face's two sides, against the JAX ShardedSolver: the same
    partition and layout (owner, pad_mask), the same state."""
    make, n, n_steps, perturb = CASES[case]
    p, mesh = make()
    _, ss, u = port_pair(p, mesh, n, perturb)
    js = jax_sharded(p, mesh, n, u)
    assert np.array_equal(ss.owner, js.owner)
    assert np.array_equal(ss.pad_mask, js.pad_mask)
    held(ss.u, np.asarray(js.u))
    ss.run(n_steps, dt=p.dt)
    js.run(n_steps, dt=p.dt)
    held(ss.gather_u(), js.gather_u(), case)


def test_forced_channel_local_dt_matches_jax_sharded():
    """The forced LES channel with time averages under local time
    stepping on 5 shards (tests/test_soa_sharding.py:186-203): compute_dt
    in the JAX padded layout, the inflow mass flux summed over shards, the
    averages, the minimum dt's clock; and the L2 residual norm reduced
    over the shards; against the JAX ShardedSolver."""
    p, mesh = les_channel_bench(order=1, dt_type=2, CFL=0.1)
    _, ss, _ = port_pair(p, mesh, 5)
    js = jax_sharded(p, mesh, 5)
    assert ss._forcing and ss._avg
    dt, dt_j = ss.compute_dt(), np.asarray(js.compute_dt())
    held(dt.numpy(), dt_j.reshape(dt.shape), "local dt")
    assert np.all(dt.numpy()[ss.pad_mask == 0] == 0)
    held(ss.norm_residual(2), js.norm_residual(2), "L2 norm")
    ss.run(4)
    js.run(4)
    held(ss.gather_u(), js.gather_u())
    held(ss.gather_u_avg(), js.gather_u_avg(), "averages")
    assert abs(ss.mdot_old - float(js._mdot_old)) <= 1e-11
    assert abs(ss.time - js.time) <= 1e-15


def test_dt_type1_and_norms_match_single_device():
    """dt_type 1 as the minimum over every shard (a 0-d tensor) and the
    residual norms reduced on the device, against the single-device
    Solver (tests/test_sharding.py:184-212), then CFL-driven runs with
    SSP-RK34, whose stages scale the dt: global, then per element."""
    p = _order2(tgv_input)()
    p.dt_type, p.CFL, p.adv_type = 1, 0.25, 2
    s1, ss, _ = port_pair(p, periodic_hex_mesh(4, 2, 2), 4, perturb=True)
    dt1, dt4 = s1.compute_dt(), ss.compute_dt()
    assert dt4.ndim == 0 and abs(float(dt4) - float(dt1)) <= 1e-12 * float(
        dt1)
    for nt in (1, 2, 3):
        held(ss.norm_residual(nt), s1.residual_norm(nt), f"norm {nt}")
        held(ss.residual_norm(nt), s1.residual_norm(nt), f"host norm {nt}")
    s1.run(3)
    ss.run(3)
    held(ss.gather_u(), s1.u)
    s1.p.dt_type = ss.p.dt_type = 2
    dt_e = s1.compute_dt()
    held(ss.compute_dt().numpy()[ss.pad_mask > 0],
         dt_e.numpy()[ss.owner[ss.pad_mask > 0]])
    s1.run(2, dt=dt_e)
    ss.run(2, dt=np.array(dt_e))        # an (E,) dt in element order
    held(ss.gather_u(), s1.u)


INLETS = {
    "sem_2d": lambda: (les_channel_input(inlet_type=2),
                       channel_quad_mesh(8, 4, 0.0, 2.0, 0.0, 1.0), 4),
    "white_noise_2d": lambda: (les_channel_input(inlet_type=1),
                               channel_quad_mesh(8, 4, 0.0, 2.0, 0.0, 1.0),
                               3),
    "sem_3d": lambda: duct_3d(n=4) + (4,),
    "white_noise_3d": lambda: duct_3d(inlet_type=1, n=4) + (3,),
}


@pytest.mark.parametrize("case", sorted(INLETS))
def test_sharded_inlet_matches_single_device(case):
    """White-noise and SEM inlets on 3-4 shards (the duct an even 4^3,
    fault 7 of ROADMAP.md): one draw stream, the plane sums over every
    shard; states and eddies against the port's Solver."""
    p, mesh, n = INLETS[case]()
    s1, ss, _ = port_pair(p, mesh, n)
    draws = [np.random.default_rng(0).random(s) if s1.turb_inlet.inlet_type
             == 2 else np.random.default_rng(0).standard_normal(s)
             for _ in range(3) for s in s1.turb_inlet.draw_shapes]
    for s in (s1, ss):
        s.set_inlet_draws(ReplayDraws(draws, "cpu", torch.float64))
        s.run(3, dt=1e-5)
    held(ss.gather_u(), s1.u, case)
    held(ss._ti_state[0].numpy(), s1._ti_state[0].numpy())
    assert np.array_equal(ss._ti_state[1].numpy(), s1._ti_state[1].numpy())


def test_sem_matches_jax_sharded():
    """SEM on 4 shards replaying the JAX key chain against the JAX
    ShardedSolver (its make_fluc_core psums the plane integrals): states
    and eddy positions."""
    p, mesh, n = INLETS["sem_2d"]()
    js = jax_sharded(p, mesh, n)
    _, ss, _ = port_pair(p, mesh, n)
    ss.set_inlet_draws(ReplayDraws(jax_draws(js.turb_inlet, None, 5), "cpu",
                                   torch.float64))
    for s in (ss, js):
        s.run(5, dt=1e-5)
    held(ss.gather_u(), js.gather_u())
    held(ss._ti_state[0].numpy(), np.asarray(js._ti_state[0]))
    assert np.array_equal(ss._ti_state[1].numpy(),
                          np.asarray(js._ti_state[1]))


def test_sharded_snapshot_scatter_and_checkpoint(tmp_path):
    """snapshot/restore on the shards, scatter_u as gather_u's inverse,
    and an HDF5 checkpoint written from the gathered state and read back
    onto the shards (sharding.py:1360-1408)."""
    pytest.importorskip("h5py")
    p, mesh = _order2(tgv_input)(), periodic_hex_mesh(4, 2, 2)
    _, ss, _ = port_pair(p, mesh, 3)
    snap = ss.snapshot()
    ss.run(2, dt=p.dt)
    u2 = ss.gather_u()
    path = ss.save_checkpoint(str(tmp_path), 2)
    ss.restore(snap)
    assert ss.time == 0.0 and not np.array_equal(ss.gather_u(), u2)
    ss.scatter_u(u2)
    assert np.array_equal(ss.gather_u(), u2)
    _, back, _ = port_pair(p, mesh, 2)
    t = back.load_checkpoint(path)
    assert t == back.time > 0 and np.array_equal(back.gather_u(), u2)


def test_sharded_refuses():
    """No fallback: what the sharded path does not run raises, naming it."""
    p = _order2(tgv_input)()
    with pytest.raises(NotImplementedError, match="ShardedMixedSolver"):
        ShardedSolver(run_input_from(p), mesh_from(periodic_prism_mesh(
            2, 2, 2)), devices=select_devices(2, "cpu"))
    q = run_input_from(p)
    q.patch = 1
    with pytest.raises(NotImplementedError, match="patch"):
        ShardedSolver(q, mesh_from(periodic_hex_mesh(2, 2, 2)),
                      devices=select_devices(2, "cpu"))
    with pytest.raises(ValueError, match="needs an element"):
        ShardedSolver(run_input_from(p), mesh_from(periodic_hex_mesh(
            2, 1, 1)), devices=select_devices(3, "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            select_devices(2)
    assert select_devices(3, "cpu") == [torch.device("cpu")] * 3
