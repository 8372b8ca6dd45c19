"""The long validation runs of the PyTorch port against the JAX package at
f64 on the CPU, at small sizes: scripts/validate_torch_tgv.py's TKE curve
against the JAX Solver's with the JAX package's integral_quantities, its
dissipation rule and its comparison with validation/tgv_re1600.json, and
the forced channel with body_force_type 1 (the deadbeat forcing) to step
60 (chip_smoke.py runs these at full width on the card)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from hifiles_tpu.config.params import RunInput as JaxRunInput
from hifiles_tpu.io.history import integral_quantities
from hifiles_tpu.mesh.generate import channel_hex_mesh, periodic_hex_mesh
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.dirname(__file__))
from chip_smoke import CHANNEL_DECK, channel_bf1_input  # noqa: E402
from test_torch_graph import IdentityGraph, count_plain  # noqa: E402
import validate_torch_tgv as vt  # noqa: E402

torch.set_num_threads(1)


def jax_tgv_input(order, n1):
    """The deck of scripts/validate_tgv.py:44-63 with the JAX package's
    RunInput."""
    p = JaxRunInput()
    p.equation = 0
    p.viscous = 1
    p.order = order
    p.ic_form = 7
    p.adv_type = 3
    p.riemann_solve_type = 3
    p.dt_type = 0
    p.vcjh_scheme_hexa = 1
    p.dx_cyclic = p.dy_cyclic = p.dz_cyclic = 2 * np.pi
    p.gamma, p.R_gas, p.fix_vis = 1.4, 286.9, 1
    p.prandtl = 0.72
    p.Mach_free_stream, p.T_free_stream = 0.1, 300.0
    p.rho_free_stream = 0.0008421095852102401
    p.mu_gas = 1.827e-5
    p.L_free_stream = 1.0
    p.Mach_c_ic, p.T_c_ic, p.rho_c_ic = 0.1, 300.0, 0.0008421095852102401
    p.dt = 1.440389e-5 * 16.0 / n1
    p.setup_params()
    return p


def test_tke_curve_matches_jax(monkeypatch):
    """The TGV deck at 4^3, p=2, f64 to t = 0.5 (250 steps, a TKE sample
    every 25): the port's tke_curve, through the capture seam, against the
    JAX Solver stepped in the same chunks and sampled by the JAX package's
    integral_quantities, within 1e-12 relative; the clocks agree; one
    capture serves every chunk, each other step a replay, five volume
    kernel launches a step."""
    order, n1, t_end = 2, 4, 0.5
    jp = jax_tgv_input(order, n1)
    js = JaxSolver(jp, periodic_hex_mesh(n1, n1, n1))
    chunk = int(round(0.05 / jp.dt))
    ts_j = [js.time]
    tke_j = [integral_quantities(js, ["kineticenergy"])["kineticenergy"]
             / vt.VOL]
    for _ in range(int(round(t_end / (chunk * jp.dt)))):
        js.run(chunk, dt=jp.dt)
        ts_j.append(js.time)
        tke_j.append(integral_quantities(js, ["kineticenergy"])
                     ["kineticenergy"] / vt.VOL)

    p = vt.tgv_input(order, n1)
    assert p.dt == jp.dt and p.mu_inf == jp.mu_inf
    s = IdentityGraph.seam(hifiles_tpu_torch.Solver(
        p, hifiles_tpu_torch.periodic_hex_mesh(n1, n1, n1), device="cpu",
        dtype=torch.float64))
    # the card's launch count: one a grouped call
    count_plain(monkeypatch, "volume_tdisf")
    tracing.reset()
    ts, tkes = vt.tke_curve(s, t_end)
    steps = chunk * (len(ts_j) - 1)
    launches = tracing.record()["launches"]["volume_tdisf"]["launches"]
    assert (s.run_path, s.captures, s.replays, launches) == (
        "SoA (fast) captured", 1, steps - 1, s.n_stages * steps)
    tracing.reset()
    np.testing.assert_allclose(ts, ts_j, rtol=1e-15, atol=0)
    assert np.abs(tkes - tke_j).max() <= 1e-12 * np.abs(tke_j).max()
    assert tkes[0] == pytest.approx(0.125, rel=1e-6)
    assert tkes[-1] < tkes[0]


def test_dissipation_is_validate_tgv_rule():
    """dissipation() is validate_tgv.py:90-92's midpoint rule, bit for bit,
    on seeded samples."""
    rng = np.random.default_rng(0)
    ts = np.cumsum(0.05 + 1e-6 * rng.random(41)) - 0.05
    tkes = 0.125 - np.cumsum(1e-4 * rng.random(41))
    tm, diss = vt.dissipation(ts, tkes)
    assert np.array_equal(tm, 0.5 * (ts[1:] + ts[:-1]))
    assert np.array_equal(diss, -np.diff(tkes) / np.diff(ts))
    assert tm.shape == diss.shape == (40,) and (diss > 0).all()


@pytest.mark.parametrize("fault,failed", [
    (None, set()),
    # every sample up by 1% of the peak: the laminar gate (2.5e-5) fails
    ("shifted", {"laminar"}),
    # the curve 0.5 later: it starts after the JAX curve, and the
    # laminar, peak-time and RMS gates fail
    ("delayed", {"covers", "laminar", "peak_time", "rms"}),
    # a run cut at t = 4: it does not span the JAX curve, and its RMS and
    # peak gates fail
    ("cut", {"covers", "rms", "peak", "peak_time", "dns_pass"})])
def test_compare_gates(fault, failed):
    """compare() passes validation/tgv_re1600.json against itself and
    fails it shifted by 1% of its peak, delayed by 0.5 or cut at t = 4."""
    with open(vt.JAX_CURVE) as fh:
        ref = json.load(fh)
    curve = dict(ref)
    if fault == "shifted":
        curve["dissipation"] = list(np.asarray(ref["dissipation"])
                                    + 0.01 * ref["peak_dissipation"])
    elif fault == "delayed":
        curve["t"] = list(np.asarray(ref["t"]) + 0.5)
    elif fault == "cut":
        curve.update(t=ref["t"][:80], dissipation=ref["dissipation"][:80])
    out = vt.compare(curve, vt.JAX_CURVE)
    assert {k for k, ok in out["checks"].items() if not ok} == failed
    assert out["ok"] == (not failed)
    assert set(out["checks"]) == {"finite", "covers", "tke0", "laminar",
                                  "rms", "peak", "peak_time", "dns_pass"}
    if fault is None:
        assert out["laminar_max_diff"] == out["rms_vs_jax"] == 0.0
        assert out["laminar_samples"] == 80 and out["jax_samples"] == 280
        assert out["laminar_bound"] == pytest.approx(2.5447e-5, rel=1e-4)
        assert out["rms_bound"] == pytest.approx(2.3995e-4, rel=1e-4)


def test_forced_channel_type_1_matches_jax():
    """The `channel` deck with body_force_type 1 at 4^3, p=2, f64, in
    10-step chunks to step 60: the port's L1 rows match the JAX Solver's
    within 1e-9 relative after every chunk, both stay finite, and the
    forcing holds the mass flux to mdot0."""
    jp = JaxRunInput.from_deck(CHANNEL_DECK)
    jp.order, jp.body_force_type = 2, 1
    js = JaxSolver(jp, channel_hex_mesh(4, 4, 4))
    p = channel_bf1_input(order=2)
    s = hifiles_tpu_torch.Solver(
        p, hifiles_tpu_torch.channel_hex_mesh(4, 4, 4), device="cpu",
        dtype=torch.float64)
    assert (p.body_force_type, p.dt) == (1, jp.dt)
    for _ in range(6):
        js.run(10, dt=jp.dt)
        s.run(10, dt=p.dt)
        r_j, r_t = js.residual_norm(1), s.residual_norm(1)
        assert np.isfinite(r_j).all() and np.isfinite(r_t).all()
        assert np.all(np.abs(r_t - r_j) <= 1e-9 * np.abs(r_j)), (r_t, r_j)
        assert np.isfinite(s.u).all()
        assert abs(s.mdot_old / p.body_force_mdot0 - 1.0) < 1e-3
