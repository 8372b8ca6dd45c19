"""Mixed-element meshes in the PyTorch port (hifiles_tpu_torch): the mixed
residual on one flat global slot space and MixedSolver, against the JAX
package's make_mixed_residual_soa and MixedSolver at f64 on the CPU.

Residuals are held at the tolerance of tests/test_mixed_soa.py:24-34
(1e-10 * max(scale, 1) per element type) on its perturbed states
(:37-41), with geometry compression on and off.  Solver runs, the
featured loop and the reference-binary goldens are in
tests/test_torch_mixed_runs.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.config.params import (ADIABAT_WALL, CYCLIC, BCParams,
                                       RunInput)
from hifiles_tpu.mesh.generate import (channel_prism_tet_mesh,
                                       periodic_mixed_mesh_2d,
                                       periodic_prism_mesh)
from hifiles_tpu.solver.multiblock import MixedSolver as JaxMixedSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import (mesh_from, run_input_from,
                                       states_from_numpy, states_to_numpy)

sys.path.insert(0, os.path.dirname(__file__))
from test_face_path import tgv_input  # noqa: E402
from test_mixed import vortex_input  # noqa: E402
from test_mixed_wall_model import _mixed_wall_mesh, _wm_input  # noqa: E402
from test_rans_viscous_bc import _rans_channel_input  # noqa: E402

torch.set_num_threads(1)

DECKS = os.path.join(os.path.dirname(__file__), "decks")


def mixed_box():
    return periodic_mixed_mesh_2d(6, 6, -10, 10, -10, 10)


def viscous_roem():
    p = vortex_input(order=2, viscous=1)
    p.riemann_solve_type = 2
    return p, mixed_box()


def les(model):
    p = vortex_input(order=2, viscous=1)
    p.LES, p.SGS_model = 1, model
    p.C_s, p.filter_ratio, p.filter_type = 0.1, 2.0, 2
    return p, mixed_box()


def over_int():
    p = vortex_input(order=2, viscous=1)
    p.over_int, p.over_int_order = 1, 4
    return p, mixed_box()


def wall_model_channel():
    p = _wm_input()
    p.dx_cyclic = 4.0
    return p, _mixed_wall_mesh()


def rans_channel():
    p = _rans_channel_input()
    p.dx_cyclic = 4.0
    p.bc_list = [BCParams(name="Cyc", flag=CYCLIC),
                 BCParams(name="unused", flag=CYCLIC),
                 BCParams(name="Wall", flag=ADIABAT_WALL)]
    return p, _mixed_wall_mesh()


def prism_tet_wm():
    p = RunInput.from_deck(os.path.join(DECKS, "input_prism_tet_wm_25"))
    return p, channel_prism_tet_mesh(3, 2, 2, 2, x1=2.0, y1=1.0, z1=1.0)


def prism_tgv():
    p = tgv_input()
    p.order = 2
    return p, periodic_prism_mesh(2, 2, 2)


# the cases of tests/test_mixed_soa.py the port covers, and a pure-prism
# TGV (the prisms' tri and quad faces on one flat point axis)
RESIDUAL_CASES = {
    "inviscid_vortex": lambda: (vortex_input(order=3), mixed_box()),
    "viscous_roem": viscous_roem,
    "les_smagorinsky": lambda: les(0),
    "les_similarity": lambda: les(4),
    "over_int": over_int,
    "wall_model_channel": wall_model_channel,
    "rans_channel": rans_channel,
    "prism_tet_wm": prism_tet_wm,
    "prism_tgv": prism_tgv,
}


def pair(p, mesh):
    """The JAX MixedSolver and the port's (CPU) MixedSolver of one deck
    and mesh."""
    return (JaxMixedSolver(p, mesh),
            hifiles_tpu_torch.MixedSolver(run_input_from(p), mesh_from(mesh),
                                          device="cpu"))


def perturbed(js, amp=0.02, seed=0):
    """tests/test_mixed_soa.py::_perturbed: each type's state times
    (1 + amp * uniform) from one seeded generator, as (E_t, U_t, F)."""
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(u) * (1.0 + amp * rng.random(np.asarray(u).shape))
                 for u in js.u)


@pytest.mark.parametrize("compress", [True, False],
                         ids=["compressed", "full_geometry"])
@pytest.mark.parametrize("case", sorted(RESIDUAL_CASES))
def test_mixed_residual_matches_jax(case, compress, monkeypatch):
    if not compress:
        monkeypatch.setenv("HIFILES_NO_GEO_COMPRESS", "1")
    p, mesh = RESIDUAL_CASES[case]()
    js, ts = pair(p, mesh)
    assert js.residual_soa is not None and ts.cts == js.cts
    for ct in ts.cts:
        np.testing.assert_array_equal(ts.mt.sels[ct], js.mt.sels[ct])
    if case in ("wall_model_channel", "prism_tet_wm"):
        assert ts._wm_tables is not None and ts._bc_fns.wm_tables is not None
    u = perturbed(js)
    want = js.residual_soa(tuple(jnp.asarray(a.transpose(1, 2, 0))
                                 for a in u))
    got = ts.residual_soa(states_from_numpy(u, "cpu", torch.float64))
    assert len(got) == len(want) == len(ts.cts)
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.numpy()
        scale = np.abs(a).max()
        assert b.shape == a.shape and np.isfinite(b).all() and scale > 0
        assert np.abs(a - b).max() < 1e-10 * max(scale, 1.0), \
            (case, np.abs(a - b).max(), scale)


def test_states_round_trip_exact():
    """convert.states_from_numpy / states_to_numpy: a JAX MixedSolver
    state (E_t, U_t, F) per type and the port's (U_t, F, E_t) tensors."""
    js, ts = pair(*over_int())
    u = perturbed(js)
    t = states_from_numpy(u, "cpu", torch.float64)
    assert [x.shape for x in t] == [a.transpose(1, 2, 0).shape for a in u]
    back = states_to_numpy(t)
    assert all(np.array_equal(a, b) for a, b in zip(u, back))
    ts.set_state(u, tuple(np.zeros_like(a) for a in u), 0.25)
    assert all(np.array_equal(a, b) for a, b in zip(u, ts.u))
    assert ts.time == 0.25 and ts.dof == sum(a.shape[0] * a.shape[1]
                                            for a in u)


def test_mixed_and_prism_meshes_need_mixed_solver():
    """Solver refuses mixed and pure-prism meshes and names MixedSolver
    (hifiles_tpu/solver/elements.py:269-271); MixedSolver takes both."""
    for p, mesh in (prism_tgv(), (vortex_input(order=2), mixed_box())):
        with pytest.raises(NotImplementedError, match="MixedSolver"):
            hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                     device="cpu")
        s = hifiles_tpu_torch.MixedSolver(run_input_from(p), mesh_from(mesh),
                                          device="cpu")
        assert isinstance(s.u, tuple) and len(s.u) == len(s.cts)
        assert s.compute_dt() == JaxMixedSolver(p, mesh).compute_dt()


def rans_hllc():
    p, mesh = rans_channel()
    p.riemann_solve_type = 3
    return p, mesh


def local_dt():
    p, mesh = vortex_input(order=2), mixed_box()
    p.dt_type, p.CFL = 2, 0.5
    return p, mesh


def patched():
    p, mesh = vortex_input(order=2), mixed_box()
    p.patch, p.patch_type, p.patch_x = 1, 1, 0.0
    return p, mesh


# what no JAX path runs (RANS+HLLC: the deck parsers refuse the pair,
# config/params.py:467-471) or what the JAX MixedSolver leaves out (patch,
# a per-element dt): MixedSolver refuses each by name, when it is built
# or, for the per-element dt, when it is asked to step with one (dt_type 2
# builds: its compute_dt gives one global dt, as the JAX MixedSolver's
# does).  Equation 1 and turbulent inlets run (test_torch_adv_diff.py,
# test_torch_turb_inlet.py).
RAISES = {
    "rans_hllc": (rans_hllc, "SA-RANS with HLLC"),
    "local_dt": (local_dt, "per-element dt"),
    "patch": (patched, "patch"),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_unsupported_cases_raise(case):
    make, match = RAISES[case]
    p, mesh = make()
    with pytest.raises(NotImplementedError, match=match):
        s = hifiles_tpu_torch.MixedSolver(run_input_from(p), mesh_from(mesh),
                                          device="cpu")
        s.run(1, dt=torch.full((mesh.n_cells,), 1e-4, dtype=torch.float64))
