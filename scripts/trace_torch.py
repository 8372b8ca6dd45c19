"""The program's own tracing (hifiles_tpu_torch.tracing) on the card, read
the way the benchmark reads it, and the checks on it:

  python3 scripts/trace_torch.py [--workload W] [--n N] [--chunk-steps C]
                                 [--seconds S] [--seed SEED]
                                 [--driver-n M] [--driver-steps K]
                                 [--out chiprun_out/trace_torch.json]

Phase ``cell``: the benchmark's cell W (bench_h100; default
tgv_re1600_160.mon50) on its own mesh, or at N^3 hexes with ``--n``
(chunks of C steps, default its traffic's), traced as ``--trace 1`` traces
it, its per-layer metrics and program_trace.report: set-up by
``setup.*`` span, the monitor row by ``monitor.*`` span, the replayed
step's device ms by part and kernel class, the traced chunk's idle gaps by
innermost program span; and the checks: every replay's device operations
against ``captured_nodes``, the clocks' offset, the share of the
constructor that the ``setup.*`` spans cover and of the benchmark's
``monitor`` span that the ``monitor.*`` spans cover.

Phase ``driver`` (with ``--driver-n``): ``python -m hifiles_tpu_torch``
in this process on the M^3 TGV p=4 (chip_smoke.tgv_deck), K steps in
chunks of 50 with a monitor row each, ``--profile``: whether the chrome
trace's ``hf.*`` ranges nest as the in-memory record's spans, and the
profiled chunk's wall against the others'.

Phase ``cost``: host microseconds of one span without a profiler and with
one.

Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELL = "tgv_re1600_160.mon50"


def card():
    """The card's name and power limit."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def run_cell(n, seed, seconds, device="cuda", chunk_steps=None,
             workload=CELL):
    """One traced run of ``workload`` on its mesh, or at n^3 hexes where
    ``n``, on ``device`` (chunks of ``chunk_steps`` steps, default the
    traffic's): (result, its lines for stderr, program_trace.report,
    checks)."""
    from bench_h100 import program_trace as pt
    from bench_h100 import run, spec
    from bench_h100.metrics.common import replay_ops, untraced
    grabbed = {}
    reader = spec.reader

    def keeping(name):
        fn = reader(name)

        def read(rec):
            grabbed["rec"] = rec
            return fn(rec)
        return read
    spec.reader = keeping
    try:
        cell = spec.Cell(spec.load(), workload)
        if n:
            cell.config = dict(cell.config,
                               mesh=dict(cell.config["mesh"], n=[n, n, n]))
        if chunk_steps:
            cell.traffic = dict(cell.traffic, chunk_steps=chunk_steps)
        result, lines = run.run_cell(cell, seed, seconds, 1, device)
    finally:
        spec.reader = reader
    rec, prog = grabbed["rec"], pt.program_record()
    ops = replay_ops(rec) or []
    cap = prog["captures"][-1] if prog["captures"] else None
    children = [s for s in prog["spans"]
                if s.name.startswith("setup.") and s.name.count(".") == 1]
    chunks = untraced(rec)
    bench_monitor = sum(b - a for name, a, b in rec.spans
                        if name == "monitor"
                        and any(c["t0"] <= a <= c["t1"] for c in chunks))
    prog_monitor = sum(s.end_ns - s.start_ns for s in prog["spans"]
                       if s.name.startswith("monitor.")
                       and pt._in_chunks(s.start_ns, chunks)) * 1e-9
    steps = sum(c["steps"] for c in rec.chunks if c["traced"])
    checks = {
        "replay_ops": len(ops), "traced_steps": steps,
        "captured_nodes": None if cap is None else cap["nodes"],
        "counters": prog["counters"],
        "ops_beyond_replays": (None if cap is None
                               else len(ops) - steps * cap["nodes"]),
        "replay_parts_found": pt.replay_parts(rec, prog) is not None,
        "clock_offset_s": pt.clock_offset(rec),
        "clock_deviation_s": (pt.clock_deviations(rec) or (None, None))[1],
        "setup_cover": sum(s.end_ns - s.start_ns for s in children) * 1e-9
        / rec.solver_init_s,
        "solver_init_s": rec.solver_init_s,
        "setup_span_over_solver_init": pt.setup_seconds(prog, "setup")
        / rec.solver_init_s,
        "monitor_cover": (prog_monitor / bench_monitor if bench_monitor
                          else None),
    }
    if cap is not None and ops:
        N = cap["nodes"]
        body = sorted(ops, key=lambda o: (o.start, o.end))[len(ops)
                                                          - steps * N:]
        first = [o.name for o in body[:N]]
        checks["replays_unlike_the_first"] = [
            k for k in range(1, steps)
            if [o.name for o in body[k * N:(k + 1) * N]] != first]
    return result, lines, pt.report(rec, prog), checks


def nesting(events):
    """[(name, parent name or None)] of ranges [(name, start, end)] in
    order of their start: each range's innermost enclosing range."""
    out, stack = [], []
    for name, a, b in sorted(events, key=lambda e: (e[1], -e[2])):
        while stack and not (stack[-1][1] <= a and b <= stack[-1][2]):
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, a, b))
    return out


def trace_nesting(path):
    """nesting() of the ``hf.*`` ranges of a chrome trace (the program's
    spans), names without the prefix."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return nesting([(e["name"][3:], e["ts"], e["ts"] + e["dur"])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in ("cpu_op", "user_annotation")
                    and e.get("name", "").startswith("hf.")])


def record_nesting(spans):
    """[(name, parent name or None)] of the record's spans in order of
    their start, a parent outside ``spans`` counted as None."""
    names = {s.id: s.name for s in spans}
    return [(s.name, names.get(s.parent))
            for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))]


def matches_trace(path, spans):
    """Whether the trace's hf.* ranges are a run of the record's spans
    (in start order) with the same names and parents."""
    want = trace_nesting(path)
    have = record_nesting(spans)
    names = [n for n, _ in want]
    for i in range(len(have) - len(want) + 1):
        if [n for n, _ in have[i:i + len(want)]] == names:
            window = sorted(spans, key=lambda s: (s.start_ns,
                                                  -s.end_ns))[i:i + len(want)]
            return bool(want) and record_nesting(window) == want
    return False


def run_driver(n, steps, device="cuda"):
    """The driver on the n^3 TGV with --profile on ``device``: the
    nesting check and the chunks' walls."""
    from chip_smoke import tgv_deck
    from hifiles_tpu_torch import periodic_hex_mesh, tracing
    from hifiles_tpu_torch.driver import main
    from hifiles_tpu_torch.mesh.gambit import write_gambit
    with tempfile.TemporaryDirectory() as d:
        write_gambit(periodic_hex_mesh(n, n, n), os.path.join(d, "box.neu"))
        deck = os.path.join(d, "run.deck")
        with open(deck, "w") as f:
            f.write(tgv_deck("box.neu", order=4, n_steps=steps,
                             monitor_res_freq=50, plot_freq=0,
                             restart_dump_freq=0,
                             integral_quantities="1 kineticenergy"))
        t0 = time.perf_counter()
        rc = main([deck, "--outdir", os.path.join(d, "out"), "--profile",
                   "--device", device])
        wall = time.perf_counter() - t0
        spans = tracing.record()["spans"]
        path = os.path.join(d, "out", "torch_trace")
        hf = trace_nesting(path)
        chunks = [s for s in spans if s.name in ("first_chunk", "steps")]
        monitors = [s for s in spans
                    if s.name == "monitor" and s.parent is None]
        return {"rc": rc, "wall_s": wall, "hf_ranges": len(hf),
                "hf_names": sorted({n for n, _ in hf}),
                "nests_as_record": matches_trace(path, spans),
                "chunk_walls_s": [(s.end_ns - s.start_ns) * 1e-9
                                  for s in chunks],
                "monitor_walls_s": [(s.end_ns - s.start_ns) * 1e-9
                                    for s in monitors],
                "profiled_chunk": 1 if steps > 50 else 0}


def span_cost(n=100_000):
    """Host microseconds per span without a profiler and with one."""
    import torch
    from hifiles_tpu_torch import tracing
    from torch.profiler import ProfilerActivity, profile

    def burst():
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6
    off = min(burst() for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if torch.cuda.is_available() else [ProfilerActivity.CPU]):
        on = min(burst() for _ in range(3))
    return {"span_us_no_profiler": off, "span_us_profiler": on}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--chunk-steps", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=3000001801)
    ap.add_argument("--driver-n", type=int, default=0)
    ap.add_argument("--driver-steps", type=int, default=200)
    ap.add_argument("--out", default="chiprun_out/trace_torch.json")
    a = ap.parse_args(argv)
    out = {"card": card()}
    result, lines, rep, checks = run_cell(a.n, a.seed, a.seconds,
                                          chunk_steps=a.chunk_steps,
                                          workload=a.workload)
    out["cell"] = dict(workload=a.workload, n=a.n, chunk_steps=a.chunk_steps,
                       result=result, report=rep, checks=checks)
    for line in lines:
        print(line, file=sys.stderr)
    if a.driver_n:
        out["driver"] = dict(n=a.driver_n, **run_driver(a.driver_n,
                                                         a.driver_steps))
    out["cost"] = span_cost()
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
