"""Solver of the PyTorch port (hifiles_tpu_torch.Solver) against the JAX
Solver at f64 on the CPU: RK45 steps from a handed-over state, the state
conversion, and the configurations that are not ported yet (the feature
physics is in test_torch_features.py)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu import HEX
from hifiles_tpu.config.params import (ADIABAT_WALL, CYCLIC, SUB_IN_SIMP,
                                       BCParams)
from hifiles_tpu.mesh.core import build_faces
from hifiles_tpu.mesh.generate import channel_hex_mesh, periodic_hex_mesh
from hifiles_tpu.ops.operators import build_tensor_ops
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import (mesh_from, run_input_from,
                                       state_from_numpy, state_to_numpy)
from hifiles_tpu_torch.solver.bc import make_bc_functions
from hifiles_tpu_torch.solver.elements import build_element_block
from hifiles_tpu_torch.solver.residual import ResidualConfig
from hifiles_tpu_torch.solver.residual_soa import make_residual_soa

sys.path.insert(0, os.path.dirname(__file__))
from test_face_path import tgv_input  # noqa: E402

torch.set_num_threads(1)


def test_rk45_steps_match_jax():
    """5 RK45 steps of a 4^3 p=3 TGV from a perturbed state handed across
    with convert.state_from_numpy: the state and the L1 monitor row agree
    at 1e-10 relative."""
    p = tgv_input()
    mesh = periodic_hex_mesh(4, 4, 4)
    js = JaxSolver(p, mesh)
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    rng = np.random.default_rng(0)
    js.u = js.u * (1.0 + 0.01 * jnp.asarray(rng.random(js.u.shape)))
    ts.set_state(np.asarray(js.u), np.asarray(js.reg), js.time)
    js.run(5, dt=p.dt)
    ts.run(5, dt=p.dt)
    assert ts.time == pytest.approx(js.time, rel=1e-15)
    u_j, u_t = np.asarray(js.u), ts.u
    assert u_t.shape == u_j.shape and np.isfinite(u_t).all()
    assert np.abs(u_t - u_j).max() < 1e-10 * np.abs(u_j).max()
    r_j, r_t = js.residual_norm(1), ts.residual_norm(1)
    assert np.all(np.abs(r_t - r_j) < 1e-10 * np.abs(r_j))
    # isentropic vortex: an analytic target (the port's Solver holds its
    # own copy of the deck)
    p.test_case = ts.p.test_case = 1
    e_j, e_t = js.compute_error(2), ts.compute_error(2)
    assert np.all(e_j[0] > 0)
    assert np.all(np.abs(e_t - e_j) <= 1e-10 * np.abs(e_j))


@pytest.mark.parametrize("adv_type", [0, 1, 2, 3, 4])
def test_step_matches_jax(adv_type):
    """One step of each RK scheme on a fixed linear rhs, in place on
    tensors, against solver/step.py."""
    from hifiles_tpu.solver.step import make_step_fn as jax_step_fn
    from hifiles_tpu_torch.solver.step import make_step_fn
    rng = np.random.default_rng(2)
    u0, reg0, c = (rng.random((6, 5, 4)) for _ in range(3))
    dt = 0.1
    uj, rj = jax_step_fn(lambda u: -0.5 * u + c, adv_type)(
        jnp.asarray(u0), jnp.asarray(reg0), dt)
    ct = torch.from_numpy(c)
    ut, rt = torch.from_numpy(u0.copy()), torch.from_numpy(reg0.copy())
    ut2, rt2 = make_step_fn(lambda u: -0.5 * u + ct, adv_type)(ut, rt, dt)
    assert ut2 is ut                 # updated in place
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(rt2.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("adv_type", [0, 1, 2, 3, 4])
def test_step_post_stage_matches_jax(adv_type):
    """The post-stage hook (shock capture's place) after every stage update,
    against solver/step.py's post_stage; the port's hook works in place."""
    from hifiles_tpu.solver.step import make_step_fn as jax_step_fn
    from hifiles_tpu_torch.solver.step import make_step_fn
    rng = np.random.default_rng(3)
    u0, reg0, c = (rng.random((6, 5, 4)) for _ in range(3))
    dt = 0.1
    uj, rj = jax_step_fn(lambda u: -0.5 * u + c, adv_type,
                         post_stage=lambda u: 0.9 * u + 0.01)(
        jnp.asarray(u0), jnp.asarray(reg0), dt)
    ct = torch.from_numpy(c)
    ut, rt = torch.from_numpy(u0.copy()), torch.from_numpy(reg0.copy())
    ut2, rt2 = make_step_fn(lambda u: -0.5 * u + ct, adv_type,
                            post_stage=lambda u: u.mul_(0.9).add_(0.01))(
        ut, rt, dt)
    assert ut2 is ut
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(rt2.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_convert_round_trip_exact(dtype):
    rng = np.random.default_rng(1)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    u = rng.random((7, 8, 5)).astype(np_dtype)
    reg = rng.random((7, 8, 5)).astype(np_dtype)
    ut, rt = state_from_numpy(u, reg, "cpu", dtype)
    assert ut.shape == (8, 5, 7) and ut.dtype == dtype and ut.is_contiguous()
    assert torch.equal(ut[3, 2], torch.from_numpy(u[:, 3, 2]))
    u2, r2 = state_to_numpy(ut, rt)
    assert u2.dtype == np_dtype
    assert np.array_equal(u2, u) and np.array_equal(r2, reg)


def test_rans_hllc_raises():
    """RANS with HLLC: the JAX SoA residual refuses it (its HLLC star states
    carry no SA field) and the JAX package falls back to its slot path,
    which the port does not have.  The deck check refuses the pairing too,
    so it is set after setup_params."""
    p = tgv_input()
    p.RANS = 1
    assert p.riemann_solve_type == 3
    with pytest.raises(NotImplementedError, match="SA-RANS with HLLC"):
        hifiles_tpu_torch.Solver(run_input_from(p),
                                 mesh_from(periodic_hex_mesh(3, 3, 3)),
                                 device="cpu")


def test_local_dt_raises():
    """dt_type 2 builds and steps with its per-element dt; a local dt
    whose length is not the block's element count is refused by name."""
    p = tgv_input()
    p.dt_type, p.CFL = 2, 0.5
    s = hifiles_tpu_torch.Solver(run_input_from(p),
                                 mesh_from(periodic_hex_mesh(3, 3, 3)),
                                 device="cpu")
    dt = s.compute_dt()
    assert dt.shape == (27,) and bool((dt > 0).all())
    with pytest.raises(ValueError, match="local dt"):
        s.run(1, dt=dt[:26])


def test_boundary_faces_raise():
    """Boundary faces need the boundary functions; with them the residual
    builds, a turbulent inlet's group included (an inflow with
    inlet_type > 0 under LES, refused before the inlets were ported)."""
    mesh = channel_hex_mesh(3, 2, 3)
    dc = np.array([2 * np.pi, 0.0, np.pi])
    conn = build_faces(mesh, {0: CYCLIC, 1: ADIABAT_WALL}, dc)
    p = tgv_input()
    ops = build_tensor_ops(HEX, 2, p.upts_type_hexa, p.vcjh_scheme_hexa,
                           p.eta_hexa)
    block = build_element_block(mesh, conn, ops, delta_cyclic=dc)
    assert block.bdy_slot.size
    cfg = ResidualConfig(viscous=True, riemann_solve_type=3, n_fields=5,
                         mu_inf=1e-3)
    with pytest.raises(NotImplementedError, match="boundary faces"):
        make_residual_soa(block, cfg, "cpu", torch.float64)
    p.LES = 1
    p.bc_list = [BCParams(name="Cyclic", flag=CYCLIC),
                 BCParams(name="Inflow", flag=SUB_IN_SIMP, rho=1.0,
                          velocity=(1.0, 0.0, 0.0), inlet_type=1)]
    bc = make_bc_functions(run_input_from(p), block, cfg, "cpu",
                           torch.float64)
    assert SUB_IN_SIMP in bc.flags
    make_residual_soa(block, cfg, "cpu", torch.float64, bc)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        hifiles_tpu_torch.Solver(run_input_from(tgv_input()),
                                 mesh_from(periodic_hex_mesh(3, 3, 3)),
                                 device="cuda")


def test_entry_points_default_to_the_card():
    """Solver() and select_device() run on the card unless the caller asks
    for the CPU; without a GPU they raise and never fall back."""
    import inspect
    from hifiles_tpu_torch.backend import select_device
    for fn in (hifiles_tpu_torch.Solver, select_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert select_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        select_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        hifiles_tpu_torch.Solver(run_input_from(tgv_input()),
                                 mesh_from(periodic_hex_mesh(2, 2, 2)))


def test_solver_takes_only_the_ports_types():
    """The JAX package's RunInput and MeshData go through convert first."""
    p, mesh = tgv_input(), periodic_hex_mesh(2, 2, 2)
    with pytest.raises(TypeError, match="run_input_from"):
        hifiles_tpu_torch.Solver(p, mesh_from(mesh), device="cpu")
    with pytest.raises(TypeError, match="mesh_from"):
        hifiles_tpu_torch.Solver(run_input_from(p), mesh, device="cpu")
