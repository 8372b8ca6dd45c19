#!/usr/bin/env python3
"""TGV Re=1600 validation run of the PyTorch port (hifiles_tpu_torch) on the
card: the counterpart of scripts/validate_tgv.py.

  python3 scripts/validate_torch_tgv.py [--n1 16] [--devices N]
      [--t-end T] [--out validation/tgv_re1600_torch.json]

Runs the reference's Taylor-Green deck (validate_tgv.py:44-63; n1^3 hexes,
16 by default, p=4, f32, dt scaled by 16/n1) to t = 14 (--t-end) on the
captured path of the port's Solver (one step captured as a CUDA graph,
27,999 replays at 16^3), or with --devices N of its ShardedSolver in N
shards on the cards (round-robin; each card captures its segments of the
step), samples TKE/vol every 0.05 with the port's
io.history.integral_quantities, and holds the dissipation curve
-d(TKE)/dt against the JAX package's own run at that resolution,
validation/tgv_re1600.json (16^3) or tgv_re1600_32.json (32^3), with
``compare``: including validate_tgv.py's PASS rule against the DNS peak
recorded there, or, for a run to --t-end 4 or less, the laminar gates
alone over the JAX samples it reaches.  Writes the JAX file's keys plus
``vs_jax`` (the comparison) and ``device`` (nvidia-smi's name and power
limit of every card) to --out (by default
validation/tgv_re1600_torch.json, tgv_re1600_32_torch.json at 32^3);
exits 1 when a gate fails.  Imports torch, numpy and hifiles_tpu_torch
only.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
JAX_CURVE = os.path.join(ROOT, "validation", "tgv_re1600.json")
OUT = os.path.join(ROOT, "validation", "tgv_re1600_torch.json")
# the JAX package's runs by resolution, and where the port's go
JAX_CURVES = {16: JAX_CURVE,
              32: os.path.join(ROOT, "validation", "tgv_re1600_32.json")}
OUTS = {16: OUT, 32: os.path.join(ROOT, "validation",
                                  "tgv_re1600_32_torch.json")}
VOL = 8.0 * np.pi ** 3
# the TKE sample spacing, as validate_tgv.py's (the DNS curve's resolution)
SAMPLE = 0.05
# the gates against the JAX curve (see compare)
TKE0_RTOL = 1e-6
LAMINAR_T = 4.0
LAMINAR_TOL = 2e-3          # of the JAX peak dissipation
PEAK_RTOL = 0.02
PEAK_T_TOL = 0.25           # 5 samples
RMS_OF_DNS = 0.5            # of the JAX curve's own RMS distance to DNS


def tgv_input(order=4, n1=16):
    """The shipped TGV deck (ref testcases/.../input_TGV_SD_hex) as
    validate_tgv.py:44-63 builds it, with the port's RunInput: dt
    1.440389e-5 * 16 / n1 physical seconds (5.0e-4 after setup_params at
    n1 = 16)."""
    from hifiles_tpu_torch.config.params import RunInput
    p = RunInput()
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


def tke(solver):
    """Volume-averaged kinetic energy, TKE / (8 pi^3) (plotstats.py's
    normalization), from the state read to the host in f64 (a sharded
    run's gathered into its single-device twin)."""
    from hifiles_tpu_torch.io.history import integral_quantities
    if hasattr(solver, "sync_twin"):
        solver = solver.sync_twin()
    return integral_quantities(solver, ["kineticenergy"])["kineticenergy"] \
        / VOL


def tke_curve(solver, t_end, sample=SAMPLE, log=None):
    """Step ``solver`` to ``t_end`` in chunks of round(sample / dt) steps
    (``solver.run(chunk, dt=dt)``) and sample TKE/vol after each chunk.
    Returns (t, tke) as arrays, t from the solver's own clock, the first
    sample at its time at the call; ``log(i, t, tke)`` every 40 chunks."""
    dt = solver.p.dt
    chunk = max(1, int(round(sample / dt)))
    n_chunks = int(round(t_end / (chunk * dt)))
    ts, tkes = [solver.time], [tke(solver)]
    for i in range(n_chunks):
        solver.run(chunk, dt=dt)
        ts.append(solver.time)
        tkes.append(tke(solver))
        if log is not None and (i + 1) % 40 == 0:
            log(i + 1, ts[-1], tkes[-1])
    return np.array(ts), np.array(tkes)


def dissipation(ts, tkes):
    """-d(TKE)/dt by the midpoint rule of validate_tgv.py:90-92: (the
    midpoints, the rates)."""
    return 0.5 * (ts[1:] + ts[:-1]), -np.diff(tkes) / np.diff(ts)


def compare(curve, reference, laminar_only=False):
    """The port's curve (a dict with the JAX file's ``tke0``, ``t`` and
    ``dissipation``) against the JAX package's (``reference``: that file's
    path, or its dict).  The curve is interpolated onto the JAX times
    before any pointwise comparison; its peak is its own sample's.
    Gates: the curve spans the JAX samples; TKE(0) within 1e-6 relative;
    over t <= 4 (laminar) max |D - D_jax| <= 2e-3 of the JAX peak; the RMS
    of D - D_jax over the JAX samples at most half the JAX curve's RMS
    distance to DNS; the peak within 2% and its time within 0.25 of the
    JAX peak's; validate_tgv.py's PASS rule (:123-126) against the
    recorded DNS peak (time within 15%, value within 20%); every sample
    finite.  ``laminar_only``: a run to t <= 4, held over the JAX samples
    up to its end by the finite, span, TKE(0) and laminar gates alone.
    Returns the readings, ``checks`` (gate -> passed) and ``ok``."""
    if not isinstance(reference, dict):
        with open(reference) as f:
            reference = json.load(f)
    t, d = np.asarray(curve["t"]), np.asarray(curve["dissipation"])
    t_j = np.asarray(reference["t"])
    d_j = np.asarray(reference["dissipation"])
    if laminar_only:
        keep = t_j <= min(t[-1], LAMINAR_T) + 1e-9
        t_j, d_j = t_j[keep], d_j[keep]
    diff = np.interp(t_j, t, d) - d_j
    lam = t_j <= LAMINAR_T
    ref_pk = reference["peak_dissipation"]
    i_pk = int(np.argmax(d))
    peak, peak_t = float(d[i_pk]), float(t[i_pk])
    dns_pk, dns_pk_t = (reference["dns_peak_dissipation"],
                        reference["dns_peak_time"])
    out = dict(
        tke0=float(curve["tke0"]),
        tke0_rel_err=abs(curve["tke0"] - reference["tke0"])
        / reference["tke0"],
        laminar_samples=int(lam.sum()),
        laminar_max_diff=float(np.abs(diff[lam]).max()),
        laminar_bound=LAMINAR_TOL * ref_pk,
        jax_peak_dissipation=ref_pk, jax_peak_time=reference["peak_time"],
        peak_rel_err=abs(peak - ref_pk) / ref_pk,
        peak_time_diff=abs(peak_t - reference["peak_time"]),
        rms_vs_jax=float(np.sqrt(np.mean(diff ** 2))),
        rms_bound=RMS_OF_DNS * reference["rms_vs_dns"],
        samples=int(t.size), jax_samples=int(t_j.size))
    out["checks"] = checks = dict(
        finite=bool(np.isfinite(d).all() and np.isfinite(curve["tke0"])),
        covers=bool(t[0] <= t_j[0] + 1e-9 and t[-1] >= t_j[-1] - 1e-9),
        tke0=out["tke0_rel_err"] <= TKE0_RTOL,
        laminar=out["laminar_max_diff"] <= out["laminar_bound"],
        rms=out["rms_vs_jax"] <= out["rms_bound"],
        peak=out["peak_rel_err"] <= PEAK_RTOL,
        peak_time=out["peak_time_diff"] <= PEAK_T_TOL,
        dns_pass=(abs(peak_t - dns_pk_t) <= 0.15 * dns_pk_t
                  and abs(peak - dns_pk) <= 0.2 * dns_pk))
    if laminar_only:
        for gate in ("rms", "peak", "peak_time", "dns_pass"):
            del checks[gate]
    out["laminar_only"] = laminar_only
    out["ok"] = all(checks.values())
    return out


def card_name(all_cards=False):
    """nvidia-smi's name and power limit of the first card (of every
    visible card, one per line, with ``all_cards``)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    lines = [x.strip() for x in res.stdout.strip().splitlines()]
    return "; ".join(lines) if all_cards else lines[0]


def validate(order=4, n1=16, t_end=14.0, device="cuda", dtype=torch.float32,
             log=None, devices=None, laminar_only=False):
    """The TGV run on ``device`` and its comparison: returns the record
    (the JAX file's keys, ``vs_jax``, and the run's ``run_path``,
    ``captures``, ``replays``, ``steps``, ``volume_kernel_launches``,
    ``dof_rk_stage_per_s``).  ``devices``: the run in that many shards of
    ShardedSolver, placed by select_devices.  On the card the run must
    take one capture and replay it for every other step ("SoA (fast)
    captured", "... (shards on N cards)"), launching the volume kernel 5
    times a step on each card; a miss raises.  The JAX run of the same
    resolution is the reference (JAX_CURVES; the 16^3 run at other
    sizes); ``laminar_only``: a run to t <= 4 held by the laminar gates
    alone (compare)."""
    from hifiles_tpu_torch import Solver, periodic_hex_mesh, tracing
    from hifiles_tpu_torch.parallel import ShardedSolver, select_devices
    p = tgv_input(order, n1)
    mesh = periodic_hex_mesh(n1, n1, n1)
    if devices:
        s = ShardedSolver(p, mesh, select_devices(devices, device),
                          dtype=dtype)
        n_cards = len(set(s.devices))
    else:
        s = Solver(p, mesh, device=device, dtype=dtype)
        n_cards = 1
    tracing.reset(launches_only=True)
    t0 = time.perf_counter()
    ts, tkes = tke_curve(s, t_end, SAMPLE, log)
    wall = time.perf_counter() - t0
    steps = int(round(SAMPLE / p.dt)) * (ts.size - 1)
    launches = tracing.record()["launches"]["volume_tdisf"]["launches"]
    if s.device.type == "cuda":
        path = "SoA (fast) captured" + (f" (shards on {n_cards} cards)"
                                        if n_cards > 1 else "")
        need = dict(run_path=path, captures=1, replays=steps - 1,
                    launches=s.n_stages * steps * n_cards)
        got = dict(run_path=s.run_path, captures=s.captures,
                   replays=s.replays, launches=launches)
        if got != need:
            raise AssertionError(f"TGV run on the card: {got}, expected "
                                 f"{need}")
    tm, diss = dissipation(ts, tkes)
    i_pk = int(np.argmax(diss))
    rec = {
        "order": order, "mesh": f"{n1}^3", "t_end": float(ts[-1]),
        "tke0": float(tkes[0]),
        "peak_dissipation": float(diss[i_pk]), "peak_time": float(tm[i_pk]),
        "wall_seconds": wall, "t": tm.tolist(), "dissipation": diss.tolist(),
    }
    with open(JAX_CURVES.get(n1, JAX_CURVE)) as f:
        ref = json.load(f)
    rec["vs_jax"] = compare(rec, ref, laminar_only=laminar_only)
    for key in ("dns_peak_dissipation", "dns_peak_time"):
        rec[key] = ref[key]
    # the DNS curve itself is not in the repository (validate_tgv.py:24-25)
    rec["rms_vs_dns"] = None
    rec.update(dtype=str(dtype)[6:], run_path=s.run_path,
               captures=s.captures, replays=s.replays, steps=steps,
               volume_kernel_launches=launches,
               dof_rk_stage_per_s=s.dof * s.n_stages * steps / wall)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n1", type=int, default=16, choices=sorted(JAX_CURVES))
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--t-end", type=float, default=14.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("validate_torch_tgv: CUDA is not available")
    a.out = a.out or OUTS[a.n1]
    card = card_name(all_cards=a.devices > 1)
    print(f"device: {card}", flush=True)
    rec = validate(n1=a.n1, t_end=a.t_end, devices=a.devices,
                   laminar_only=a.t_end <= LAMINAR_T,
                   log=lambda i, t, k: print(f"t = {t:6.2f}  tke = {k:.6f}",
                                             flush=True))
    rec["device"] = card
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
    v = rec["vs_jax"]
    print(f"TKE(0) = {rec['tke0']:.14f} (rel err {v['tke0_rel_err']:.3e})")
    print(f"peak dissipation {rec['peak_dissipation']:.6f} at t = "
          f"{rec['peak_time']:.3f} (JAX {v['jax_peak_dissipation']:.6f} at "
          f"t = {v['jax_peak_time']:.3f}; DNS "
          f"{rec['dns_peak_dissipation']:.6f} at t = "
          f"{rec['dns_peak_time']:.3f})")
    print(f"vs JAX: RMS {v['rms_vs_jax']:.3e} (bound {v['rms_bound']:.3e}), "
          f"laminar max |diff| {v['laminar_max_diff']:.3e} (bound "
          f"{v['laminar_bound']:.3e}); checks {v['checks']}")
    print(f"{rec['steps']} steps in {rec['wall_seconds']:.1f} s, "
          f"{rec['dof_rk_stage_per_s']:.4e} DOF*RK-stage/s, run path "
          f"{rec['run_path']!r}, captures {rec['captures']}, replays "
          f"{rec['replays']}, volume kernel launches "
          f"{rec['volume_kernel_launches']}; on [{card}]")
    print("VALIDATION", "PASS" if v["ok"] else "FAIL")
    return 0 if v["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
