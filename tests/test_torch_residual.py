"""SoA residual of the PyTorch port (hifiles_tpu_torch/solver/residual_soa.py)
against the JAX package's make_residual_soa, at f64 on the CPU, with the
tolerance of tests/test_residual_soa.py (1e-10 * max(scale, 1))."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.mesh.generate import periodic_hex_mesh
from hifiles_tpu.solver.residual_soa import make_residual_soa as jax_soa
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.solver.residual_soa import make_residual_soa

sys.path.insert(0, os.path.dirname(__file__))
from test_face_path import tgv_input  # noqa: E402

torch.set_num_threads(1)


def _viscous_hllc():
    return tgv_input(), periodic_hex_mesh(4, 4, 4)


def _inviscid_rusanov():
    p = tgv_input()
    p.viscous = 0
    p.riemann_solve_type = 0
    p.mu_inf = float("nan")
    return p, periodic_hex_mesh(3, 3, 3)


@pytest.fixture(scope="module")
def solvers():
    """One JAX and one port solver per configuration (built once)."""
    out = {}
    for name, make in (("viscous_hllc", _viscous_hllc),
                       ("inviscid_rusanov", _inviscid_rusanov)):
        p, mesh = make()
        out[name] = (JaxSolver(p, mesh),
                     hifiles_tpu_torch.Solver(run_input_from(p),
                                              mesh_from(mesh), device="cpu"))
    return out


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("case", ["viscous_hllc", "inviscid_rusanov",
                                  "perturbed"])
def test_residual_matches_jax(solvers, case, compress, monkeypatch):
    if compress:
        monkeypatch.delenv("HIFILES_NO_GEO_COMPRESS", raising=False)
    else:
        monkeypatch.setenv("HIFILES_NO_GEO_COMPRESS", "1")
    js, ts = solvers["viscous_hllc" if case == "perturbed" else case]
    u = np.asarray(js.u)                                 # (E, U, F)
    if case == "perturbed":
        rng = np.random.default_rng(0)
        u = u * (1.0 + 0.01 * rng.random(u.shape))
    u_soa = np.ascontiguousarray(np.transpose(u, (1, 2, 0)))
    want = np.asarray(jax_soa(js.block, js.rcfg, jnp.float64)(
        jnp.asarray(u_soa)))
    got = make_residual_soa(ts.block, ts.rcfg, "cpu", torch.float64)(
        torch.from_numpy(u_soa)).numpy()
    assert got.shape == want.shape == u_soa.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err < 1e-10 * max(scale, 1.0), (err, scale)


def test_lift_gemm_adds_in_place(solvers):
    """BlockStages.gradient adds the face lift to tg inside the lift GEMM
    (addmm_): the same as tg + the lift's own product to 1e-12 in f64, and
    the physical gradient (K3's plain version on the CPU) the same as
    from that sum."""
    from hifiles_tpu_torch.solver.residual_soa import BlockStages, Physics
    _, ts = solvers["viscous_hllc"]
    ph = Physics(ts.rcfg, 3)
    k = BlockStages(ts.block, ph, "cpu", torch.float64)
    rng = np.random.default_rng(7)
    u = torch.from_numpy(rng.random((k.U, ph.nF, k.E)) + 1.0)
    delta = torch.from_numpy(rng.normal(size=(ph.nF, k.E, k.Pf)))
    tg0 = k.tgrad(u)
    want = tg0 + k.lift(k.S.opp_5_stack.view(3 * k.U, k.Pf),
                        delta).view(tg0.shape)
    tg, gr = k.gradient(tg0.clone(), delta)
    scale = max(want.abs().max().item(), 1.0)
    assert (tg - want).abs().max().item() <= 1e-12 * scale
    want_gr = torch.stack([sum(k.S.jg_u[m, l][:, None] * want[m]
                               for m in range(3)) * k.S.inv_det_u
                           for l in range(3)])
    scale = max(want_gr.abs().max().item(), 1.0)
    assert (gr - want_gr).abs().max().item() <= 1e-12 * scale
