"""Element-sharded runs of mixed-element and prism meshes in the PyTorch
port (hifiles_tpu_torch.parallel.ShardedMixedSolver) on the CPU, in f64:
N shards on one controller against the port's single-device MixedSolver
from the same seeded state, for the cases of tests/test_mixed_sharding.py
and test_prism_sharding.py, the per-type gather_u held to
1e-11 * max(scale, 1).  The tri+quad box with counts no shard count
divides is also held to the JAX package's ShardedMixedSolver on the
virtual CPU devices of tests/conftest.py (the JAX compile of its sharded
prism/tet channel takes half a minute; turned tri faces on halo faces are
held to the JAX ShardedSolver on tets in tests/test_torch_sharding.py)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hifiles_tpu.config.params import RunInput
from hifiles_tpu.mesh.generate import (channel_mixed_mesh_2d,
                                       channel_prism_tet_mesh,
                                       periodic_mixed_mesh_2d,
                                       periodic_prism_mesh)
from hifiles_tpu.parallel.mixed_sharding import \
    ShardedMixedSolver as JaxShardedMixedSolver

from hifiles_tpu_torch import MixedSolver
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.parallel import ShardedMixedSolver, select_devices

sys.path.insert(0, os.path.dirname(__file__))
from test_mixed_sharding import _wall_mesh_and_input, vortex_input  # noqa
from test_prism_sharding import prism_input  # noqa: E402
from test_turb_inlet import les_channel_input  # noqa: E402

torch.set_num_threads(1)

DECKS = os.path.join(os.path.dirname(__file__), "decks")


def held(got, want, what=""):
    """Per type: |got - want| <= 1e-11 * max(scale, 1)."""
    assert len(got) == len(want), what
    scale = max(max(np.abs(np.asarray(w)).max() for w in want), 1.0)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all(), what
        err = np.abs(g - w).max()
        assert err <= 1e-11 * scale, (what, err, scale)


def vortex(viscous=1, **attrs):
    p = vortex_input(viscous)
    for k, v in attrs.items():
        setattr(p, k, v)
    return p


def box(nx=8, ny=8):
    return periodic_mixed_mesh_2d(nx, ny, -10, 10, -10, 10)


def prism_tet_wm():
    p = RunInput.from_deck(os.path.join(DECKS, "input_prism_tet_wm_25"))
    return p, channel_prism_tet_mesh(4, 2, 2, 1, x1=2.0, y1=1.0, z1=1.0)


def forced_prism_tet_wm():
    """tests/test_mixed_featured.py:54-85: the wall-modelled prism/tet
    channel with body forcing and running averages."""
    p = RunInput.from_deck(os.path.join(DECKS, "input_prism_tet_wm_bench"))
    p.forcing, p.body_force_type = 1, 0
    p.body_force_area = 1.0
    p.body_force_mdot0 = 0.0
    p.average_fields = ["rho_average", "u_average", "w_average"]
    p.spinup_time = 0.0
    return p, channel_prism_tet_mesh(4, 2, 1, 1, x1=2.0, y1=1.0, z1=1.0)


def ramped_tri_quad():
    from test_mixed_featured import _ramped_channel_input
    return _ramped_channel_input(), channel_mixed_mesh_2d(4, 2, 0.0, 2.0,
                                                          0.0, 1.0)


def wall(**kw):
    mesh, p = _wall_mesh_and_input(**kw)
    return p, mesh


def inviscid_prisms():
    """prism_input(1) with viscosity off: prism_input(0) leaves the
    viscous scales unset and its initial state NaN."""
    p = prism_input(1)
    p.viscous = 0
    return p, periodic_prism_mesh(2, 2, 2)


# name -> (deck and mesh, shards, steps, dt (None: the deck's)); the
# prism TGV boxes start from their initial condition (the 2% noise on
# their free-stream density makes the inviscid box blow up)

CASES = {
    "tri_quad_inviscid": (lambda: (vortex(0), box()), 4, 5, 5e-4),
    "tri_quad_viscous": (lambda: (vortex(1), box()), 4, 5, 5e-4),
    "tri_quad_indivisible": (lambda: (vortex(1), box(5, 3)), 4, 5, 5e-4),
    "tri_quad_wall_model": (lambda: wall(wall_model=1), 4, 5, None),
    "tri_quad_rans": (lambda: wall(rans=1), 4, 5, None),
    "tri_quad_similarity": (lambda: (vortex(1, LES=1, SGS_model=4, C_s=0.5,
                                            filter_type=2, filter_ratio=2.0),
                                     box()), 4, 5, 5e-4),
    "tri_quad_les_shock_overint": (lambda: (vortex(
        1, order=3, LES=1, SGS_model=1, C_s=0.5, filter_type=2,
        filter_ratio=2.0, over_int=1, over_int_order=4, shock_cap=1,
        shock_det=0, s0=-6.0, expf_fac=4.0, expf_order=4), box(6, 6)), 4, 3,
                                   5e-4),
    "tri_quad_svv": (lambda: (vortex(1, LES=1, SGS_model=3,
                                     filter_ratio=2.0), box(4, 4)), 3, 3,
                     1e-4),
    "tri_quad_ramped": (ramped_tri_quad, 3, 4, 1e-4),
    "prisms_inviscid": (inviscid_prisms, 4, 5, 1e-3),
    "prisms_viscous": (lambda: (prism_input(1), periodic_prism_mesh(
        2, 2, 2)), 4, 5, 1e-3),
    "prism_tet_wall_model": (prism_tet_wm, 4, 3, None),
    "prism_tet_forced_wm": (forced_prism_tet_wm, 3, 3, None),
}


def port_pair(p, mesh, n, perturb=True):
    """The port's MixedSolver and its ShardedMixedSolver on ``n`` CPU
    shards from the same initial state, perturbed by 2% when asked."""
    s1 = MixedSolver(run_input_from(p), mesh_from(mesh), device="cpu")
    ss = ShardedMixedSolver(run_input_from(p), mesh_from(mesh),
                            devices=select_devices(n, "cpu"))
    u = s1.u
    if perturb:
        rng = np.random.default_rng(0)
        u = tuple(a * (1.0 + 0.02 * rng.random(a.shape)) for a in u)
        for s in (s1, ss):
            s.set_state(u, tuple(np.zeros_like(a) for a in u), 0.0)
    return s1, ss, u


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_mixed_matches_single_device(case):
    """n shards == the single-device MixedSolver after a few RK45 steps:
    the per-type states, the JAX layout of ``u``, and the featured carry
    (averages, mass-flux memory, ramp counter)."""
    make, n, n_steps, dt = CASES[case]
    p, mesh = make()
    dt = p.dt if dt is None else dt
    s1, ss, _ = port_pair(p, mesh, n, not case.startswith("prisms"))
    assert ss.n_halo > 0 and ss.dof == s1.dof
    assert not hasattr(ss, "compute_dt")
    for s in (s1, ss):
        s.run(n_steps, dt=dt)
    held(ss.gather_u(), s1.u, case)
    for ct, a, w in zip(ss.cts if hasattr(ss, "cts") else s1.cts, ss.u,
                        s1.u):
        real = ss.pad_ct[ct].reshape(-1) > 0
        assert a.shape == (n, ss.E_loc[ct]) + w.shape[1:]
        held([a.reshape(-1, *w.shape[1:])[real]], [w])
    if s1.u_avg is not None:
        held(ss.gather_u_avg(), s1.u_avg, case + " averages")
        assert abs(ss.mdot_old - s1.mdot_old) <= 1e-11 * max(
            abs(s1.mdot_old), 1.0)
    if s1._has_ramp:
        assert float(ss._k) == float(s1._k) == 1.0 + n_steps
    held([ss.norm_residual(1)], [s1.residual_norm(1)], case + " L1 norm")


def test_sharded_mixed_matches_jax_sharded():
    """6 quads + 18 tris over 4 shards (per-type shards of unequal size)
    against the JAX ShardedMixedSolver from the same state: the per-type
    partition and the state."""
    case = "tri_quad_indivisible"
    make, n, n_steps, dt = CASES[case]
    p, mesh = make()
    dt = p.dt if dt is None else dt
    _, ss, u = port_pair(p, mesh, n)
    js = JaxShardedMixedSolver(p, mesh, devices=jax.devices()[:n],
                               dtype=jnp.float64)
    for ct in js.cts:
        assert np.array_equal(ss.owner_ct[ct], js.owner_ct[ct])
        assert np.array_equal(ss.sizes_ct[ct], js.sizes_ct[ct])
    js.scatter_u(u)
    ss.run(n_steps, dt=dt)
    js.run(n_steps, dt=dt)
    held(ss.gather_u(), js.gather_u(), case)


def test_sharded_mixed_refuses_inlets():
    """Turbulent inlets on a mixed mesh raise, as the JAX
    ShardedMixedSolver does (mixed_sharding.py:458-462)."""
    p = les_channel_input(inlet_type=2, n_eddy=8)
    mesh = channel_mixed_mesh_2d(4, 2, 0.0, 2.0, 0.0, 1.0)
    with pytest.raises(NotImplementedError, match="turbulent inlets"):
        ShardedMixedSolver(run_input_from(p), mesh_from(mesh),
                           devices=select_devices(2, "cpu"))


def test_sharded_mixed_scatter_and_twin():
    """scatter_u as gather_u's inverse, and sync_twin: the single-device
    twin holding the run's state, clock and residual."""
    p, mesh = vortex(1), box(4, 4)
    _, ss, _ = port_pair(p, mesh, 3)
    ss.run(2, dt=5e-4)
    u = ss.gather_u()
    twin = ss.sync_twin()
    assert twin is ss.base and twin.time == ss.time
    held(twin.u, u)
    held([twin.residual_norm(2)], [ss.norm_residual(2)])
    ss.scatter_u(tuple(2.0 * a for a in u))
    held(ss.gather_u(), tuple(2.0 * a for a in u))
