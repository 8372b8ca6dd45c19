"""The benchmark of hifiles_tpu_torch, the counterpart of the repository's
root ``bench.py`` (which stays the JAX package's):

  python -m hifiles_tpu_torch.bench [CONFIG ...]

runs each named configuration (default: every one of ALL_CONFIGS, in
bench.py's order) on the card at bench.py's full widths in f32, gates it on
bench.py's goldens, and prints after each configuration, on stdout, the
cumulative JSON line of bench.py's ``emit`` (bench.py:419-451): ``metric``,
``value``, ``unit``, ``vs_baseline``, ``gated`` and, with more than one
configuration, ``configs`` (each entry with its captured median ``value``,
``gated``, its ``vs_baseline`` where REFERENCE_BASELINE.json has one, its
``eager`` median and its captured ``quartiles``) and ``configs_done``.  On
stderr it prints each configuration's measured row beside its golden, its
volume kernel launches and ``bench[<name>]: <rate> (gated=..., <s>s)``.  A
configuration that fails raises: the lines of the ones before it stand.

The protocol is the port's (run_config): 10 steps (on the card they warm
up and capture the step graph), then the rate from interleaved 10-step
repeats, captured and eager, each restored from the step-10 state (rates),
then 10 captured steps more and the gate on the state after 10 + 10, the
goldens' protocol.  Where bench.py times one 100-step run min-of-3, the
port reports the median of its repeats, with their quartiles.

bench.py's size knobs BENCH_ORDER, BENCH_MESH and BENCH_STEPS are
arguments of run_config and the case builders here, for small twins in
the tests; at other sizes than bench.py's a configuration is not gated.
BENCH_TIMED_STEPS and BENCH_PRECISION have no counterpart: the repeats are
fixed at 10 steps, and TF32 is always off (backend.select_device).

The module imports torch, numpy and hifiles_tpu_torch only.  Its entry
points run on the card and raise without CUDA unless a function is given
``device="cpu"``; the command line takes config names and nothing else.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time

import numpy as np
import torch

from . import (HEX, PRISM, QUAD, TET, TRI, MixedSolver, RunInput, Solver,
               channel_hex_mesh, channel_prism_tet_mesh, periodic_hex_mesh,
               periodic_mixed_mesh_2d)
from .backend import select_device
from .solver.volume import reset_counters, volume_tdisf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "tests", "decks")
CHANNEL_DECK = os.path.join(DECKS, "input_channel_les_bench")
MIXED3D_DECK = os.path.join(DECKS, "input_prism_tet_wm_bench")
REFERENCE_BASELINE = os.path.join(ROOT, "REFERENCE_BASELINE.json")

# f32 L1 residual rows after 10 + 10 steps, recorded on the CPU by the JAX
# package (scripts/gen_bench_goldens.py); copied from bench.py:52-92.
# bench.py's TPU rows (GOLDENS_TPU) and its same-platform rtol are not
# copied: this port states no number taken on a TPU, and its CPU f32
# `channel` rows miss these goldens by 7.4e-3 (fault 8 in ROADMAP.md), so
# every device is gated as bench.py gates a run on another platform.
GOLDENS = {
    "plain": [6.941142790690e-04, 4.966159536118e-02, 4.966221268805e-02,
              6.388034231193e-02, 1.170654706372e-01],
    "overint": [7.041802843269e-04, 4.966480296847e-02, 4.966359326116e-02,
                6.388326561503e-02, 1.196348554410e-01],
    "smag": [6.915991758127e-04, 4.965766590876e-02, 4.965743605242e-02,
             6.388290707427e-02, 1.164381646750e-01],
    # s0=0 fires the exp filter everywhere: rows are large by construction
    "shock": [1.088646796180e+00, 7.200999302322e+00, 7.201000897436e+00,
              2.065917861886e-01, 2.723697619697e+02],
    # SA-RANS, nu_tilde seeded at the free-stream level (run_config)
    "rans": [6.932668879263e-04, 4.965675295157e-02, 4.965730678584e-02,
             6.387954113683e-02, 1.166911509066e-01, 3.304107737779e-04],
    "mixed": [6.740825334323e-03, 2.244257251877e-02, 2.264023451759e-02,
              3.971234396777e-02],
    "mixed3d": [3.131947323206e+00, 1.117830214485e+01, 1.913928947338e+01,
                8.074575550287e-01, 1.966135718009e+02],
    "channel": [1.626676051504e-02, 7.708719019215e-01, 1.982168968139e-01,
                2.859064812405e-04, 1.132711735533e+00],
}

# The gate's rtol per configuration where it is wider than RTOL
# (bench.py:124): overint's cubature and projection GEMMs amplify the
# f32 spread of its cancellation-sensitive rho and energy rows.
GATE_RTOL = {"overint": 2e-2}
# bench.py's rtol for a row gated against another platform's golden
# (bench.py:253-254)
RTOL = 5e-3
# The channel's rows against GOLDENS["channel"], row by row.  Row 3
# (z-momentum) is f32 rounding amplified: the uniform IC carries no
# z-momentum, and bench.py:77-78,108-112 records the row at 2.86e-4 (its
# CPU golden) and at 2.3e-4 (an earlier CPU row).  On an H100 the f32 row
# reads 2.30e-4 from the IC and 2.68e-4 from the IC perturbed by 1e-7, and
# the f64 row 1.77e-4, while rows 0-2 and 4 stay within 3e-3: the deck's
# forcing amplifies rounding 1.6-fold a step (fault 8 in ROADMAP.md).  So
# row 3 is held to the spread of the f32 rows, 0.25; a corrupted flux
# moves the rows by far more (bench.py:119-121).
CHANNEL_RTOL = [RTOL, RTOL, RTOL, 0.25, RTOL]

# bench.py:131-132: plain first, then the configurations a cut run should
# still record
ALL_CONFIGS = ["plain", "mixed3d", "channel", "mixed", "overint", "smag",
               "shock", "rans"]

STEPS = 10
UNIT = "DOF*RK-stage/s"

Case = collections.namedtuple("Case", "p mesh solver dof metric gated")


def configure(p, cfg_name):
    """Apply the BENCH_CONFIG feature physics to the TGV deck
    (bench.py:135-153)."""
    if cfg_name == "plain":
        return
    if cfg_name == "overint":
        p.over_int = 1
        p.over_int_order = p.order + 2
    elif cfg_name == "smag":
        p.LES, p.SGS_model = 1, 0
        p.C_s, p.filter_ratio, p.filter_type = 0.1, 2.0, 2
    elif cfg_name == "shock":
        p.shock_cap, p.s0 = 1, 0.0     # filter fires everywhere: worst case
        p.riemann_solve_type = 2       # RoeM (BASELINE #5 pairing)
    elif cfg_name == "rans":
        p.RANS = 1                     # SA: 6-field pipeline + source
        p.riemann_solve_type = 0       # Rusanov (HLLC invalid with RANS,
        #                                ref:src/input.cpp analog)
    else:
        raise SystemExit(f"unknown BENCH_CONFIG '{cfg_name}'")


def mixed_input(order=4):
    """2-D viscous isentropic vortex, p=4 -- the mixed flagship deck
    (bench.py:156-172; ``order`` for small twins)."""
    p = RunInput()
    p.equation, p.viscous, p.order = 0, 1, order
    p.ic_form, p.test_case, p.adv_type = 0, 1, 3
    p.riemann_solve_type = 3           # HLLC
    p.dt_type, p.dt = 0, 1e-4
    p.mach_free_stream = 0.3
    p.dx_cyclic = p.dy_cyclic = 20.0
    p.mu_inf, p.rt_inf, p.c_sth = 1e-4, 1.0, 0.0
    p.fix_vis, p.prandtl = 1, 0.72
    return p


def tgv_input(cfg_name="plain", order=4, **attrs):
    """The TGV deck of bench.py:278-298 (testcases Taylor_Green_vortex) with
    configure(cfg_name) and ``attrs`` applied before setup_params, as
    bench.py:297 does."""
    p = RunInput()
    p.equation = 0
    p.viscous = 1
    p.order = order
    p.ic_form = 7
    p.adv_type = 3           # RK45, 5 stages
    p.riemann_solve_type = 3  # HLLC
    p.dt_type = 0
    p.n_steps = STEPS
    p.vcjh_scheme_hexa = 1
    p.dx_cyclic = p.dy_cyclic = p.dz_cyclic = 2 * np.pi
    p.gamma, p.R_gas, p.fix_vis = 1.4, 286.9, 1
    p.prandtl = 0.72
    p.Mach_free_stream, p.T_free_stream = 0.1, 300.0
    p.rho_free_stream = 0.0008421095852102401
    p.mu_gas = 1.827e-5
    p.L_free_stream = 1.0
    p.Mach_c_ic, p.T_c_ic, p.rho_c_ic = 0.1, 300.0, 0.0008421095852102401
    p.dt = 1.440389e-5
    configure(p, cfg_name)
    for k, v in attrs.items():
        setattr(p, k, v)
    p.setup_params()
    return p


def channel_input(order=4):
    """The deck of bench.run_channel (bench.py:392-393) at ``order``."""
    p = RunInput.from_deck(CHANNEL_DECK)
    p.order = order
    return p


def n_dof(mesh, order):
    """Solution points of ``mesh`` at ``order``, summed over its elements."""
    q = order + 1
    per_type = {TRI: q * (q + 1) // 2, QUAD: q * q,
                TET: q * (q + 1) * (q + 2) // 6, PRISM: q * q * (q + 1) // 2,
                HEX: q ** 3}
    types, counts = np.unique(mesh.ctype, return_counts=True)
    return int(sum(per_type[int(t)] * int(n) for t, n in zip(types, counts)))


def tgv_case(cfg_name, order=4, n1=16):
    """bench.run_tgv(cfg_name) (bench.py:264-319): the TGV deck on n1^3
    periodic hexes, gated at bench.py's sizes only (bench.py:312)."""
    p, mesh = tgv_input(cfg_name, order), periodic_hex_mesh(n1, n1, n1)
    suffix = "" if cfg_name == "plain" else f" +{cfg_name}"
    return Case(p, mesh, Solver, n_dof(mesh, order),
                f"TGV p={order} hex {n1}^3 viscous NS{suffix} {UNIT}",
                order == 4 and n1 == 16)


def mixed_case(order=4, n=96):
    """bench.run_mixed (bench.py:322-342): the vortex on the n^2 periodic
    tri+quad box [-10, 10]^2 through MixedSolver."""
    mesh = periodic_mixed_mesh_2d(n, n, -10, 10, -10, 10)
    return Case(mixed_input(order), mesh, MixedSolver, n_dof(mesh, order),
                f"mixed tri+quad {mesh.n_cells}c p={order} viscous vortex "
                f"{UNIT}", order == 4 and n == 96)


def mixed3d_case(nx=32, nz=32, ny_prism=4, ny_tet=4):
    """bench.run_mixed3d (bench.py:345-374): the deck
    tests/decks/input_prism_tet_wm_bench (p=2) on channel_prism_tet_mesh
    through MixedSolver."""
    p = RunInput.from_deck(MIXED3D_DECK)
    mesh = channel_prism_tet_mesh(nx, nz, ny_prism, ny_tet, x1=2.0, y1=1.0,
                                  z1=1.0)
    n_pri = int((mesh.ctype == PRISM).sum())
    return Case(p, mesh, MixedSolver, n_dof(mesh, p.order),
                f"mixed prism/tet {n_pri}p+{mesh.n_cells - n_pri}t "
                f"p={p.order} wall-modeled LES {UNIT}",
                (nx, nz, ny_prism, ny_tet) == (32, 32, 4, 4))


def channel_case(order=4, n=16):
    """bench.run_channel (bench.py:377-404): the deck
    tests/decks/input_channel_les_bench on channel_hex_mesh(n, n, n)."""
    mesh = channel_hex_mesh(n, n, n)
    return Case(channel_input(order), mesh, Solver, n_dof(mesh, order),
                f"forced-channel LES {n}^3 p={order} +averaging {UNIT}",
                order == 4 and n == 16)


def case(name, **sizes):
    """The Case of configuration ``name`` (``sizes``: its builder's)."""
    build = {"mixed": mixed_case, "mixed3d": mixed3d_case,
             "channel": channel_case}.get(name)
    return build(**sizes) if build else tgv_case(name, **sizes)


def make_solver(name, c, device, dtype):
    """The solver of Case ``c``; for `rans`, nu~ seeded at the free-stream
    level, as bench.py:305-309 does (the TGV IC leaves it 0)."""
    s = c.solver(c.p, c.mesh, device=device, dtype=dtype)
    if name == "rans":
        s.u_soa[:, -1] = c.p.mu_tilde_inf
    return s


def golden(name):
    """(golden row, rtol per row) of configuration ``name``: GOLDENS at
    GATE_RTOL's rtol (RTOL by default), the `channel` at CHANNEL_RTOL."""
    gold = GOLDENS[name]
    if name == "channel":
        return gold, CHANNEL_RTOL
    return gold, [GATE_RTOL.get(name, RTOL)] * len(gold)


def gate(name, row):
    """Hold the L1 residual ``row`` of configuration ``name`` after 10 + 10
    steps to golden(name), row by row; print it beside the golden on
    stderr (bench.py's BENCH_RECORD line); raise if a row is off or not
    finite."""
    gold, rtol = map(np.asarray, golden(name))
    res = np.asarray(row, dtype=np.float64)[:len(gold)]
    rel = np.abs(res - gold) / np.abs(gold)
    print(f"bench RECORD {name}: [{', '.join(f'{v:.12e}' for v in res)}]\n"
          f"bench golden {name}: {gold.tolist()}\n"
          f"bench rel err {name}: {[float(f'{r:.3e}') for r in rel]} "
          f"(gate {rtol.tolist()})", file=sys.stderr, flush=True)
    if not (np.isfinite(res).all() and np.all(rel < rtol)):
        raise AssertionError(f"benchmark accuracy drift vs f32 golden "
                             f"({name}): {res.tolist()} vs {gold.tolist()} "
                             f"(rel {rel.max():.2e})")


def _sync(s):
    """Wait for every card that ``s``'s shards sit on."""
    if s.device.type == "cuda":
        for dev in dict.fromkeys(getattr(s, "devices", [s.device])):
            torch.cuda.synchronize(dev)


def step_kernels(s, dt, graph=True):
    """(device kernels, memsets and copies; volume-kernel launches) of one
    traced step on the card, counted by torch.profiler: a replay of the
    captured step (its capture first, untraced, if it has none), or with
    graph=False an eager step."""
    from torch.profiler import ProfilerActivity, profile
    if graph and s._graph is None:
        s.run(1, dt=dt)
    _sync(s)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.run(1, dt=dt, graph=graph)
        _sync(s)
    cuda = torch.autograd.DeviceType.CUDA
    names = [ev.name for ev in prof.events() if ev.device_type == cuda]
    return len(names), sum(1 for n in names if "volume_tdisf" in n)


def rates(runs, repeats=6):
    """The rate of each of ``runs`` (name -> (solver, deck)), captured and
    eager, in DOF*RK-stage/s: ``repeats`` 10-step repeats of each, the
    cells taking turns and each cell's captured and eager runs alternating
    which goes first, so that all see the same host; every repeat starts
    from the cell's state at the call (a deck may stay finite only for its
    gated steps, as the `channel`'s).  Then device kernels per RK stage of
    a replayed and of an eager step (on the card; None on the CPU), and a
    check that the state stayed finite.  Every solver returns to its state
    at the call.  Returns name -> mode -> {"median", "quartiles" [q1, q3],
    "kernels"}."""
    modes = ("captured", "eager")
    samples = {name: {m: [] for m in modes} for name in runs}
    snaps = {name: s.snapshot() for name, (s, _) in runs.items()}
    for k in range(repeats):
        for name, (s, p) in runs.items():
            for mode in (modes if k % 2 == 0 else modes[::-1]):
                s.restore(snaps[name])
                _sync(s)
                t0 = time.perf_counter()
                s.run(STEPS, dt=p.dt, graph=mode == "captured")
                _sync(s)
                samples[name][mode].append(s.dof * s.n_stages * STEPS
                                           / (time.perf_counter() - t0))
    out = {}
    for name, (s, p) in runs.items():
        out[name] = {}
        for mode in modes:
            q1, med, q3 = np.percentile(samples[name][mode], [25, 50, 75])
            kernels = (step_kernels(s, p.dt, mode == "captured")[0]
                       / s.n_stages if s.device.type == "cuda" else None)
            out[name][mode] = dict(median=float(med),
                                   quartiles=[float(q1), float(q3)],
                                   kernels=kernels)
        if not np.isfinite(s.residual_norm(1)).all():
            raise AssertionError(f"{name} went non-finite in the repeats")
        s.restore(snaps[name])
    return out


def run_config(name, device="cuda", repeats=6, steps=STEPS,
               dtype=torch.float32, **sizes):
    """One configuration through the port's protocol, the counterpart of
    bench.py's _time_and_gate (bench.py:200-261): the solver in ``dtype``;
    ``steps`` steps (on the card they warm up and capture the step graph);
    rates() from that state; ``steps`` captured steps more, the state
    checked finite and its L1 residual row gated (gate) when the case is
    at bench.py's sizes, in f32 and 10 + 10 steps, the goldens' protocol.
    ``sizes`` go to the case's builder (tests only).

    The `channel` repeats restart from its step-10 state, so they time
    steps 11-20 and stay finite; bench.py times steps 11-110, which the
    deck's unstable forcing makes non-finite (fault 8 in ROADMAP.md,
    consequence 1).

    Returns dict(metric, value (the captured median), quartiles, eager
    (the eager median), gated, row, launches (the volume kernel's, by
    variant, over the whole protocol; none on the CPU))."""
    dev = select_device(device)
    c = case(name, **sizes)
    s = make_solver(name, c, dev, dtype)
    if s.dof != c.dof:
        raise AssertionError(f"{name}: the solver holds {s.dof} DOF, the "
                             f"case {c.dof}")
    reset_counters()
    s.run(steps, dt=c.p.dt)
    r = rates({name: (s, c.p)}, repeats)[name]
    s.run(steps, dt=c.p.dt)
    _sync(s)
    if dev.type == "cuda" and not s.run_path.endswith("captured"):
        raise AssertionError(f"{name}: run path {s.run_path!r} on the card")
    if not torch.isfinite(s.u_soa).all():
        raise AssertionError(f"NaN/Inf in the {name} benchmark solution")
    row = s.residual_norm(1)
    gated = c.gated and steps == STEPS and dtype == torch.float32
    if gated:
        gate(name, row)
    else:
        print(f"bench: accuracy gate SKIPPED for config={name} (no golden "
              "for these sizes)", file=sys.stderr, flush=True)
    return dict(metric=c.metric, value=r["captured"]["median"],
                quartiles=r["captured"]["quartiles"],
                eager=r["eager"]["median"], gated=gated, row=row,
                launches=dict(volume_tdisf.by_variant))


def emit(results, names, ref):
    """The cumulative JSON record of the configurations finished so far
    (bench.py:419-451), ``ref`` the REFERENCE_BASELINE.json record."""
    head = results.get("plain", next(iter(results.values())))
    per_cfg = ref.get("per_config_dof_stage_per_s", {})
    vs_baseline = 0.0
    base = ref.get("tgv_p4_hex_dof_stage_per_s", 0.0)
    if base and "plain" in results:
        vs_baseline = results["plain"]["value"] / base
    elif len(results) == 1:
        base_k = per_cfg.get(next(iter(results)))
        if base_k:
            vs_baseline = head["value"] / base_k
    out = {"metric": head["metric"], "value": head["value"], "unit": UNIT,
           "vs_baseline": vs_baseline,
           "gated": all(r["gated"] for r in results.values())}
    if len(names) > 1:
        out["configs"] = {
            k: {"value": v["value"], "gated": v["gated"],
                **({"vs_baseline": v["value"] / per_cfg[k]}
                   if per_cfg.get(k) else {}),
                "eager": v["eager"], "quartiles": v["quartiles"]}
            for k, v in results.items()}
        out["configs_done"] = f"{len(results)}/{len(names)}"
    return out


def main(argv=None):
    """Run the configurations named in ``argv`` (default: sys.argv[1:], or
    every one of ALL_CONFIGS) on the card, printing the cumulative JSON
    line after each."""
    names = list(sys.argv[1:] if argv is None else argv) or ALL_CONFIGS
    for name in names:
        if name not in ALL_CONFIGS:
            raise SystemExit(f"usage: python -m hifiles_tpu_torch.bench "
                             f"[CONFIG ...]; unknown config '{name}' (one "
                             f"of {' '.join(ALL_CONFIGS)})")
    ref = {}
    if os.path.exists(REFERENCE_BASELINE):
        with open(REFERENCE_BASELINE) as f:
            ref = json.load(f)
    results = {}
    for name in names:
        t0 = time.perf_counter()
        r = results[name] = run_config(name)
        print(f"bench[{name}] volume_tdisf launches: "
              f"{json.dumps(r['launches'])}", file=sys.stderr)
        print(f"bench[{name}]: {r['value']:.4e} DOF*stage/s (gated="
              f"{r['gated']}, {time.perf_counter() - t0:.1f}s)",
              file=sys.stderr, flush=True)
        print(json.dumps(emit(results, names, ref)), flush=True)


if __name__ == "__main__":
    main()
