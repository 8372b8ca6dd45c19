#!/usr/bin/env python3
"""Element-sharded runs of hifiles_tpu_torch with shards on several cards,
each card capturing its own shards' part of the step (parallel/cards.py).

  python3 scripts/multicard_torch.py [--parts cells driver scaling legs
                                             cells8 driver8]
                                     [--cells CONFIG ...]
                                     [--out profile_out/multicard.json]

Parts (default: cells and driver):
  cells   - bench.py's `plain` in 4 shards on 4 cards, `channel` in 3 on 3
            and `mixed3d` in 4 on 4 (hifiles_tpu_torch.bench.case, f32,
            shards placed round-robin by parallel.select_devices, as
            chip_smoke.make_sharded shards them), each beside the same
            shards on one card: 10 + 10 captured steps, the L1 residual row
            gated by bench.gate; the state after them equal, bit for bit,
            to the same shards' on one card and to 20 eager steps on the
            cards (run(..., graph=False)); the volume kernel launched once
            per card per RK stage; capture seconds and graph MiB per card,
            segments, graph launches, event records and waits per step, the
            host's microseconds to issue a step against the cards' wall per
            step, and each card's device time for 10 replays queued behind
            a device-side sleep (as scripts/replay_modes.py reads a
            replay); then the rates, captured and eager, of the cell, of
            the same shards on one card and of `plain` on one card, from
            interleaved 10-step repeats in the same turns (bench.rates);
  driver  - ``python -m hifiles_tpu_torch <deck> --devices 4`` on the
            `plain` deck written as a Gambit file (chip_smoke.py's
            driver deck: TGV p=4 on 16^3 hexes, f32, 20 steps): its run
            path, its iter-20 row gated on bench.GOLDENS["plain"], its
            history rows held to the single-device run's as
            chip_smoke.phase_driver_sharded holds them (residual norms at
            rtol 1e-3, integral quantities at 1e-6), and its ASCII restart
            at step 20 continued to step 30 against an uninterrupted
            30-step run on the cards (history row at rtol 1e-5, as
            chip_smoke.phase_driver holds the single-device restart);
  scaling - the 32^3 p=4 TGV (scripts/validate_torch_tgv.py's deck, f32):
            100 captured steps on one card against the same mesh in 4
            shards on 4 cards, after 2 steps that capture each;
and with more shards than cards, two a card on four:
  legs    - hifiles_tpu_torch.multichip.dryrun_multichip(8) on the cards
            (the JAX package's eight dry-run legs at their shapes, f32,
            each checked as the JAX leg asserts), then 2 steps more of
            each leg (replays), the volume kernel launched once per card
            and RK stage in them; each leg's state after its steps and
            the 2 more equal, bit for bit, to the same 8 shards on card 0
            and to the eager step on the cards; its segments, graph
            launches, event records and waits per step;
  cells8  - bench.py's eight configurations (CELLS8), each in 8 shards on
            4 cards, as `cells` runs its cells: gated, bit for bit the
            same 8 shards on one card and the eager step, the volume
            kernel once per card and RK stage (and variant), the host's
            issue time against the cards', and the rates beside the same
            shards on one card and `plain` on one card;
  driver8 - the `driver` part with --devices 8 (two shards a card).
Raises with fewer than 2 visible cards.  Prints every card's nvidia-smi
name and power limit, one line per reading, and writes the readings as
JSON to --out.  Imports torch, numpy and hifiles_tpu_torch only.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hifiles_tpu_torch import bench, tracing  # noqa: E402

# cell -> (bench configuration, shards = cards)
CELLS = {"plain x4": ("plain", 4), "channel x3": ("channel", 3),
         "mixed3d x4": ("mixed3d", 4)}
# cell -> (bench configuration, shards, cards): two shards a card
CELLS8 = {f"{name} x8": (name, 8, 4) for name in (
    "plain", "smag", "overint", "rans", "shock", "channel", "mixed",
    "mixed3d")}
LEG_SHARDS = 8
LEG_MORE_STEPS = 2
REPEATS = 4
DRIVER_SHARDS = 4
SLEEP_CYCLES = 400_000_000
TGV_DT = 1.440389e-5
TGV_DECK = dict(
    equation=0, viscous=1, order=4, ic_form=7, adv_type=3,
    riemann_solve_type=3, dt_type=0, dt=TGV_DT, vcjh_scheme_hexa=1,
    gamma=1.4, R_gas=286.9, fix_vis=1, prandtl=0.72, Mach_free_stream=0.1,
    T_free_stream=300.0, rho_free_stream=0.0008421095852102401,
    mu_gas=1.827e-5, L_free_stream=1.0, Mach_c_ic=0.1, T_c_ic=300.0,
    rho_c_ic=0.0008421095852102401, n_steps=20, monitor_res_freq=10,
    res_norm_type=1, plot_freq=20, write_type=0,
    diagnostic_fields="2 vorticity q_criterion",
    integral_quantities="2 kineticenergy enstropy", restart_dump_freq=20,
    restart_ascii=1)


def log(msg):
    print(f"multicard: {msg}", flush=True)


def card_names():
    """nvidia-smi's name and power limit of every visible card."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return [line.strip() for line in res.stdout.strip().splitlines()]


def need_cards(n=2):
    k = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if k < n:
        raise RuntimeError(f"multicard_torch: {k} visible cards; the "
                           f"multi-card paths need at least {n}")
    return k


def volume_launches():
    """The volume kernel's launch counts since they were last zeroed."""
    return tracing.record()["launches"]["volume_tdisf"]


def sync_all():
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def make_sharded(p, mesh, n, device, dtype=torch.float32):
    """ShardedSolver, or ShardedMixedSolver for a mesh of several element
    types or of prisms, in ``n`` shards placed by select_devices(n,
    device): "cuda" round-robin over the cards, "cuda:0" all on card 0."""
    from hifiles_tpu_torch import PRISM
    from hifiles_tpu_torch.parallel import (ShardedMixedSolver,
                                            ShardedSolver, select_devices)
    types = np.unique(mesh.ctype)
    mixed = types.size > 1 or int(types[0]) == PRISM
    return (ShardedMixedSolver if mixed else ShardedSolver)(
        p, mesh, devices=select_devices(n, device), dtype=dtype)


def state(s):
    """The state and its running averages, gathered to the host."""
    out = [s.gather_u()]
    if s.u_avg_soa is not None:
        out.append(s.gather_u_avg())
    flat = lambda x: (np.concatenate([a.ravel() for a in x])
                      if isinstance(x, tuple) else x.ravel())
    return np.concatenate([flat(x) for x in out])


def reserved():
    torch.cuda.empty_cache()
    return [torch.cuda.memory_reserved(d)
            for d in range(torch.cuda.device_count())]


def card_replays(s, n=10, k=3):
    """Per card, the least device ms of ``n`` replays of ``s``'s captured
    step queued behind a device-side sleep on every card (the host off the
    critical path), of ``k`` readings from the same state; and the host ms
    to issue them."""
    snap = s.snapshot()
    cards = list(dict.fromkeys(s.devices)) if hasattr(s, "devices") \
        else [s.device]
    best, host = [float("inf")] * len(cards), []
    for _ in range(k):
        s.restore(snap)
        sync_all()
        ev = []
        for dev in cards:
            with torch.cuda.device(dev):
                torch.cuda._sleep(SLEEP_CYCLES)
                a = torch.cuda.Event(enable_timing=True)
                a.record()
            ev.append([a])
        t0 = time.perf_counter()
        for _ in range(n):
            s._graph.replay()
        host.append(1e3 * (time.perf_counter() - t0))
        for dev, e in zip(cards, ev):
            with torch.cuda.device(dev):
                b = torch.cuda.Event(enable_timing=True)
                b.record()
            e.append(b)
        sync_all()
        best = [min(x, a.elapsed_time(b)) for x, (a, b) in zip(best, ev)]
    s.restore(snap)
    return best, min(host)


def issue_time(s, dt, n=10):
    """(host us to issue one captured step, wall ms per step to the cards'
    end) over ``n`` steps from the solver's state, which it returns to."""
    snap = s.snapshot()
    sync_all()
    t0 = time.perf_counter()
    s.run(n, dt=dt)
    t1 = time.perf_counter()
    sync_all()
    t2 = time.perf_counter()
    s.restore(snap)
    return 1e6 * (t1 - t0) / n, 1e3 * (t2 - t0) / n


def cell_spec(cell):
    """(bench configuration, shards, cards) of a cell of CELLS or CELLS8."""
    if cell in CELLS:
        name, n = CELLS[cell]
        return name, n, n
    return CELLS8[cell]


def run_cell(cell, plain):
    """One cell of CELLS or CELLS8 on the cards beside its shards on one
    card; raises on a miss.  ``plain``: `plain` on one card, (solver,
    deck), for the rates.  Returns the cell's readings."""
    name, n_shards, n = cell_spec(cell)
    c = bench.case(name)
    t0 = time.perf_counter()
    s = make_sharded(c.p, c.mesh, n_shards, "cuda")
    one = make_sharded(c.p, c.mesh, n_shards, "cuda:0")
    if name == "rans":
        # nu~ at the free-stream level, as bench.make_solver seeds it
        for x in (s, one):
            u = x.gather_u()
            u[..., -1] = c.p.mu_tilde_inf
            x.scatter_u(u)
    setup = time.perf_counter() - t0
    cards = list(dict.fromkeys(s.devices))
    if len(cards) != n:
        raise AssertionError(f"{cell}: shards on {cards}, expected {n} cards")
    ic = s.snapshot()
    rec = dict(cell=cell, cards=[str(d) for d in cards], setup_s=setup,
               dof=s.dof)
    # 10 captured steps (a warm-up, the capture, 8 replays), then 10 more,
    # the volume kernel counted over them
    before = reserved()
    s.run(10, dt=c.p.dt)
    sync_all()
    after = reserved()
    rec["capture_s"] = s.capture_seconds
    rec["graph_mib"] = [(b - a) / 2**20 for a, b in zip(before, after)][:n]
    rec["shards"] = n_shards
    tracing.reset(launches_only=True)
    s.run(10, dt=c.p.dt)
    sync_all()
    vol = volume_launches()
    k1 = dict(launches=vol["launches"],
              by_shape={f"{v} U={U} E={E}": k for (v, U, E), k in
                        vol["by_shape"].items()})
    # once per card, RK stage and variant (over-integration has two)
    need = 10 * s.n_stages * n * len(vol["by_variant"])
    rec["k1"] = dict(k1, need=need)
    if not s.run_path.endswith(f"captured (shards on {n} cards)"):
        raise AssertionError(f"{cell}: run path {s.run_path!r}")
    if k1["launches"] != need:
        raise AssertionError(f"{cell}: volume kernel launched "
                             f"{k1['launches']} times in 10 steps, expected "
                             f"{need} (once per card, RK stage and "
                             "variant)")
    row = s.residual_norm(1)
    bench.gate(name, row)
    got = state(s)
    rec["row"] = [float(x) for x in row]
    g = s._graph
    rec["schedule"] = dict(g.host_calls(), cuts=len(g.cuts))
    # the same shards on one card, and eager on the cards, from the IC
    one.run(10, dt=c.p.dt)
    one.run(10, dt=c.p.dt)
    sync_all()
    ref_one = state(one)
    live = s.snapshot()
    s.restore(ic)
    s.run(20, dt=c.p.dt, graph=False)
    sync_all()
    ref_eager = state(s)
    if not s.run_path.endswith(f"eager (shards on {n} cards)"):
        raise AssertionError(f"{cell}: eager run path {s.run_path!r}")
    s.restore(live)
    scale = float(np.abs(ref_one).max())
    for what, ref in (("one card", ref_one), ("eager", ref_eager)):
        diff = float(np.abs(got - ref).max())
        rec[f"vs_{what.replace(' ', '_')}"] = dict(
            max_abs_diff=diff, scale=scale,
            bit_for_bit=bool(np.array_equal(got, ref)))
        log(f"{cell}: after 20 steps vs {what}: max |diff| {diff:.3e} of "
            f"max |u| {scale:.6e}, bit for bit {np.array_equal(got, ref)}")
        if not np.array_equal(got, ref):
            raise AssertionError(f"{cell}: the state on {n} cards differs "
                                 f"from the {what} run's")
    rec["host_us_per_step"], rec["wall_ms_per_step"] = issue_time(s, c.p.dt)
    rec["replay_ms_per_card"], rec["replay_host_ms"] = card_replays(s)
    rec["one_card_replay_ms"], _ = card_replays(one)
    log(f"{cell}: set-up {setup:.2f} s, capture {s.capture_seconds:.3f} s, "
        f"graph MiB per card {[round(x, 1) for x in rec['graph_mib']]}; "
        f"{rec['schedule']}; host {rec['host_us_per_step']:.1f} us to issue "
        f"a step, {rec['wall_ms_per_step']:.3f} ms per step to the cards' "
        f"end; device ms of 10 replays per card "
        f"{[round(x, 3) for x in rec['replay_ms_per_card']]} (the same "
        f"shards on one card {rec['one_card_replay_ms'][0]:.3f}); volume "
        f"kernel {k1['launches']} launches in 10 steps ({k1['by_shape']})")
    runs = {"plain": plain, cell: (s, c.p), cell + " on one card": (one, c.p)}
    rates = bench.rates(runs, REPEATS)
    rec["rates"] = rates
    for name_, r in rates.items():
        for mode, x in r.items():
            log(f"rate {name_} {mode}: median {x['median']:.6e} "
                f"[{x['quartiles'][0]:.6e}, {x['quartiles'][1]:.6e}] "
                f"DOF*RK-stage/s over {REPEATS} interleaved 10-step repeats; "
                f"{x['kernels']:.1f} device kernels per RK stage (all cards)")
    return rec


def run_cells(cells=CELLS, only=None):
    """Every cell of ``cells`` (CELLS or CELLS8), or those of them whose
    configuration is in ``only``; returns their readings."""
    need_cards()
    c = bench.case("plain")
    plain = bench.make_solver("plain", c, torch.device("cuda", 0),
                              torch.float32)
    plain.run(10, dt=c.p.dt)
    out = []
    for cell in cells:
        if only and cell_spec(cell)[0] not in only:
            continue
        out.append(run_cell(cell, (plain, c.p)))
        torch.cuda.empty_cache()
    return out


def run_legs(counts=None):
    """The `legs` part: the dry run's eight legs in LEG_SHARDS shards on
    the cards, each then LEG_MORE_STEPS replayed steps, against the same
    shards on card 0 and the eager step; raises on a miss.  Returns each
    leg's readings; adds the volume kernel's counters of the replayed
    steps (``by_variant``, ``by_shape``, ``by_group``) to ``counts``."""
    from hifiles_tpu_torch import multichip
    k = need_cards()
    n = min(k, LEG_SHARDS)
    t0 = time.perf_counter()
    solvers = multichip.dryrun_multichip(LEG_SHARDS)
    log(f"legs: dryrun_multichip({LEG_SHARDS}) on {n} cards in "
        f"{time.perf_counter() - t0:.1f} s")
    recs = []
    for name, s in solvers.items():
        leg = multichip.LEGS[name]
        dt = leg.make_input().dt
        if s._card_of != [q % n for q in range(LEG_SHARDS)] \
                or s._n_cards() != n:
            raise AssertionError(f"leg {name}: shards on cards "
                                 f"{s._card_of}")
        tracing.reset(launches_only=True)
        s.run(LEG_MORE_STEPS, dt=dt)
        sync_all()
        vol = volume_launches()
        launches = vol["launches"]
        by_group = {f"{v} {list(shapes)}": q for (v, shapes), q in
                    vol["by_group"].items()}
        if counts is not None:
            for key in ("by_variant", "by_shape", "by_group"):
                counts.setdefault(key, collections.Counter()).update(
                    vol[key])
        need = LEG_MORE_STEPS * s.n_stages * n
        multichip.check_leg(name, s)
        got = state(s)
        refs = {}
        for what, device, graph in (("one card", "cuda:0", True),
                                    ("eager", "cuda", False)):
            r, p = multichip.build_leg(name, LEG_SHARDS, device)
            r.run(leg.steps, dt=p.dt, graph=graph)
            r.run(LEG_MORE_STEPS, dt=p.dt, graph=graph)
            sync_all()
            refs[what] = (state(r), r.run_path)
            del r
        sched = dict(s._graph.host_calls(), cuts=len(s._graph.cuts))
        rec = dict(leg=name, cells=int(s.mesh.n_cells), dof=s.dof,
                   run_path=s.run_path, steps=leg.steps + LEG_MORE_STEPS,
                   shard_shapes=[[list(x) for x in sh]
                                 for sh in s._shard_shapes],
                   k1=dict(launches=launches, need=need, by_group=by_group),
                   schedule=sched, capture_s=s.capture_seconds)
        for what, (ref, path) in refs.items():
            rec[f"vs_{what.replace(' ', '_')}"] = dict(
                bit_for_bit=bool(np.array_equal(got, ref)),
                max_abs_diff=float(np.abs(got - ref).max()), run_path=path)
        log(f"leg {name}: {rec['cells']} cells, shards {rec['shard_shapes']}"
            f" (U, E); run path {s.run_path!r}; {sched}; volume kernel "
            f"{launches} launches in {LEG_MORE_STEPS} replayed steps (need "
            f"{need}) {by_group}; bit for bit vs the same shards on one card "
            f"{rec['vs_one_card']['bit_for_bit']} "
            f"({refs['one card'][1]!r}), vs eager "
            f"{rec['vs_eager']['bit_for_bit']} ({refs['eager'][1]!r}); "
            f"capture {s.capture_seconds:.3f} s")
        recs.append(rec)
        if launches != need:
            raise AssertionError(f"leg {name}: volume kernel launched "
                                 f"{launches} times, expected {need}")
        for what in refs:
            if not rec[f"vs_{what.replace(' ', '_')}"]["bit_for_bit"]:
                raise AssertionError(f"leg {name}: the state on {n} cards "
                                     f"differs from the {what} run's")
    return recs


def driver_deck(mesh_file, **run):
    keys = dict(TGV_DECK, **run)
    keys.update(dx_cyclic=2 * np.pi, dy_cyclic=2 * np.pi,
                dz_cyclic=2 * np.pi, mesh_file=mesh_file,
                bc_Cyclic_type="cyclic")
    return "".join(f"{k} {v}\n" for k, v in keys.items())


def run_driver(deck, outdir, *extra):
    res = subprocess.run([sys.executable, "-m", "hifiles_tpu_torch", deck,
                          "--outdir", outdir, *extra], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"driver on {deck} {extra} exited "
                             f"{res.returncode}:\n{res.stdout[-2000:]}\n"
                             f"{res.stderr[-4000:]}")
    return res.stdout


def history_rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[:2], [np.array(line.split(), dtype=float)
                       for line in lines[2:]]


def run_driver_part(shards=DRIVER_SHARDS):
    """Path 2: the driver with --devices ``shards`` on the cards (shards a
    multiple of the cards); raises on a miss.  Returns its readings."""
    k = need_cards()
    n = min(k, shards)
    from hifiles_tpu_torch import periodic_hex_mesh
    from hifiles_tpu_torch.mesh.gambit import write_gambit
    base = os.path.join(ROOT, "build", f"multicard_driver{shards}")
    shutil.rmtree(base, ignore_errors=True)
    dirs = {k: os.path.join(base, k) for k in ("one", "cards", "whole")}
    decks = {"run": driver_deck("tgv16.neu"),
             "restart": driver_deck("tgv16.neu", n_steps=10,
                                    restart_flag=1, restart_iter=20,
                                    n_restart_files=1),
             "whole": driver_deck("tgv16.neu", n_steps=30,
                                  plot_freq=10**6, restart_dump_freq=10**6)}
    mesh = periodic_hex_mesh(16, 16, 16)
    for d in dirs.values():
        os.makedirs(d)
        write_gambit(mesh, os.path.join(d, "tgv16.neu"))
        for name, text in decks.items():
            with open(os.path.join(d, name + ".deck"), "w") as f:
                f.write(text)
    deck = lambda name, d: os.path.join(dirs[d], name + ".deck")
    dev = ["--devices", str(shards)]
    run_driver(deck("run", "one"), dirs["one"])
    t0 = time.perf_counter()
    out = run_driver(deck("run", "cards"), dirs["cards"], *dev)
    wall = time.perf_counter() - t0
    path = re.search(r"^run path: (.*)$", out, re.M).group(1)
    placed = re.search(r"^shards: (.*)$", out, re.M).group(1)
    want = ", ".join(f"cuda:{q} x{shards // n}" for q in range(n))
    if path != f"SoA (fast) captured (shards on {n} cards)" \
            or placed != f"{shards} on {want}":
        raise AssertionError(f"driver --devices: run path {path!r}, shards "
                             f"{placed!r}")
    row = np.array(re.search(r"^iter +20 .*res: (.*)$", out, re.M)
                   .group(1).split(), dtype=float)
    bench.gate("plain", row)
    head, rows = history_rows(os.path.join(dirs["cards"], "history.plt"))
    _, rows_one = history_rows(os.path.join(dirs["one"], "history.plt"))
    n_res = head[0].count('"res_')
    worst_res = worst_int = 0.0
    for a, b in zip(rows, rows_one):
        if a[0] != b[0] or a[-2] != b[-2]:
            raise AssertionError("driver --devices: history iteration or "
                                 "time differ")
        ra, rb = 10.0 ** a[1:1 + n_res], 10.0 ** b[1:1 + n_res]
        worst_res = max(worst_res, float((np.abs(ra - rb) / rb).max()))
        worst_int = max(worst_int, float(
            (np.abs(a[1 + n_res:-2] - b[1 + n_res:-2])
             / np.abs(b[1 + n_res:-2])).max()))
    log(f"driver --devices {shards}: run path {path!r}; iter-20 row "
        f"{row.tolist()} gated; history vs one card: residual norms "
        f"{worst_res:.3e} (gate 1e-3), integral quantities {worst_int:.3e} "
        f"(gate 1e-6); process {wall:.2f} s")
    if not (len(rows) == len(rows_one) == 2 and worst_res < 1e-3
            and worst_int < 1e-6):
        raise AssertionError("driver --devices: history differs from the "
                             "single-device run's")
    run_driver(deck("restart", "cards"), dirs["cards"], *dev)
    _, rows_restart = history_rows(os.path.join(dirs["cards"],
                                                "history.plt"))
    run_driver(deck("whole", "whole"), dirs["whole"], *dev)
    _, rows_whole = history_rows(os.path.join(dirs["whole"], "history.plt"))
    a, b = rows_restart[-1], rows_whole[-1]
    rel = float((np.abs(a[1:-1] - b[1:-1]) / np.abs(b[1:-1])).max())
    log(f"driver --devices {shards}: restart at 20 -> iter "
        f"{a[0]:.0f}, history row vs the uninterrupted run's: rel err "
        f"{rel:.3e} (gate 1e-5)")
    if not (a[0] == b[0] == 30 and rel < 1e-5):
        raise AssertionError("driver --devices: the restart does not "
                             "continue the run")
    return dict(run_path=path, shards=placed, row=row.tolist(),
                history_res=worst_res, history_int=worst_int,
                restart_rel=rel, process_s=wall)


def run_scaling(n1=32, steps=100):
    """Path 3's timing: ``steps`` captured steps of the n1^3 p=4 TGV on one
    card and in 4 shards on 4 cards.  Returns the readings."""
    need_cards(4)
    from hifiles_tpu_torch import Solver, periodic_hex_mesh
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from validate_torch_tgv import tgv_input
    p = tgv_input(4, n1)
    mesh = periodic_hex_mesh(n1, n1, n1)
    out = {}
    for what in ("one card", "4 cards"):
        t0 = time.perf_counter()
        s = (Solver(p, mesh, device="cuda", dtype=torch.float32)
             if what == "one card" else make_sharded(p, mesh, 4, "cuda"))
        setup = time.perf_counter() - t0
        s.run(2, dt=p.dt)
        sync_all()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            s.run(steps, dt=p.dt)
            sync_all()
            walls.append(time.perf_counter() - t0)
        w = min(walls)
        out[what] = dict(setup_s=setup, run_path=s.run_path,
                         ms_per_step=1e3 * w / steps,
                         rate=s.dof * s.n_stages * steps / w,
                         capture_s=s.capture_seconds,
                         state_mb=s.dof * s.n_fields * 4 / 1e6)
        log(f"tgv {n1}^3 p=4 on {what}: {1e3 * w / steps:.3f} ms per step "
            f"(best of 2 x {steps} captured steps), "
            f"{out[what]['rate']:.4e} DOF*RK-stage/s; set-up {setup:.1f} s; "
            f"run path {s.run_path!r}")
        del s
        torch.cuda.empty_cache()
    out["speedup"] = (out["one card"]["ms_per_step"]
                      / out["4 cards"]["ms_per_step"])
    log(f"tgv {n1}^3: 4 cards {out['speedup']:.3f}x one card")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", nargs="+", default=["cells", "driver"],
                    choices=["cells", "driver", "scaling", "legs", "cells8",
                             "driver8"])
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out",
                                                  "multicard.json"))
    ap.add_argument("--cells", nargs="+", metavar="CONFIG",
                    help="run only these configurations of the cells "
                         "and cells8 parts (a rerun within a chip budget)")
    a = ap.parse_args(argv)
    need_cards()
    names = card_names()
    for k, name in enumerate(names):
        log(f"card {k}: {name}")
    rec = dict(cards=names, torch=torch.__version__)
    parts = dict(cells=lambda: run_cells(CELLS, a.cells),
                 driver=run_driver_part, scaling=run_scaling, legs=run_legs,
                 cells8=lambda: run_cells(CELLS8, a.cells),
                 driver8=lambda: run_driver_part(8))
    failed = []
    for part in a.parts:
        t0 = time.perf_counter()
        try:
            rec[part] = parts[part]()
        except Exception as e:        # noqa: BLE001 - reported, exit 1
            import traceback
            traceback.print_exc()
            rec[part] = dict(error=repr(e))
            failed.append(part)
        log(f"part {part}: {time.perf_counter() - t0:.1f} s")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
    log(f"FAIL {failed}" if failed else "PASS")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
