"""The benchmark of hifiles_tpu_torch on the H100:

  python3 -m bench_h100.run --workload NAME --seed N --seconds S --trace 0|1

runs one cell of BENCHMARK.json from the root of a checkout, on as many
cards as the cell asks for, and prints as its last line on standard output
one JSON object: ``correct``, ``attempted`` and ``failed`` (the window's
steps, and those of a chunk whose monitor row was not finite), ``metrics``
(with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which the last lines on
standard error repeat.

A run: set-up (imports, the seed's inputs, the solver, its first
CHECKED_STEPS steps through the window's own calls: the warm-up step and
capture of the step graph, replays, the monitor row, all counted in
``setup_s``); the window, the driver's chunk loop (program.Program) until
``--seconds`` have passed, ending at a chunk boundary; with ``--trace 1``
the window's first chunk is traced by torch.profiler (and on the channel
one eager step after the window, for the boundary stage); then the
program is freed and the plain reference follows the checked steps
(check.py).  Without the cards the cell asks for, or with JAX loaded when
the window has closed, it exits with another code than 0 and prints no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hifiles_tpu")
GiB = 2 ** 30


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m bench_h100.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def jax_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Fail(Exception):
    """A run that cannot give a result."""


def cards_or_fail(chips):
    import torch
    if not torch.cuda.is_available():
        raise Fail("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise Fail(f"the cell needs {chips} cards, "
                   f"{torch.cuda.device_count()} visible")


class Peak:
    """The process's highest max_memory_allocated over the cards, across
    the resets that measure the capture alone."""

    def __init__(self, cards):
        self.cards, self.high = cards, 0

    def read(self):
        import torch
        if self.cards:
            self.high = max([self.high] + [torch.cuda.max_memory_allocated(d)
                                           for d in self.cards])
        return self.high

    def reset(self):
        import torch
        self.read()
        for d in self.cards:
            torch.cuda.reset_peak_memory_stats(d)


def run_cell(cell, seed, seconds, trace, device="cuda"):
    """One run of ``cell``; returns (result dict, lines for stderr)."""
    import numpy as np
    import torch

    from . import check, inputs, program
    from . import trace as tr
    from .reference import advance, physics

    deck = cell.deck()
    phys = physics(deck)
    box = inputs.box_of(cell.config)
    nodes = np.polynomial.legendre.leggauss(phys["order"] + 1)[0]
    # the seed's state in the configuration's precision, for both sides
    u0 = inputs.initial_state(cell.config, cell.traffic, phys, box, nodes,
                              seed).astype(np.float32).astype(np.float64)
    rec = types.SimpleNamespace(cell=cell, chips=cell.chips, box=box,
                                order=phys["order"], ops=None, ranges=None,
                                boundary_us=None, device=device)
    spans = program.Spans()
    phases = {"imports and inputs": time.perf_counter() - T0}
    with tempfile.TemporaryDirectory() as work:
        prog = program.Program(deck, inputs.mesh_arrays(box), cell.chips,
                               work, spans, device)
        phases["program"] = time.perf_counter() - T0
        s = prog.solver
        rec.solver_init_s = prog.init_s
        rec.n_stages, rec.dof = s.n_stages, s.dof
        peak = Peak(prog.cards)
        prog.set_state(u0)
        # the checked steps, through the window's calls; the first call
        # warms up and captures the step graph
        peak.reset()
        before = max([torch.cuda.memory_allocated(d) for d in prog.cards]
                     or [0])
        t0 = time.perf_counter()
        prog.steps(1)
        rec.capture_s = time.perf_counter() - t0
        rec.capture_gib = (max([torch.cuda.max_memory_allocated(d)
                                for d in prog.cards] or [0]) - before) / GiB
        phases["capture"] = time.perf_counter() - T0
        prog.steps(check.CHECKED_STEPS - 1)
        out = dict(row=prog.monitor(check.CHECKED_STEPS),
                   u=prog.state(u0.shape))
        out["ke"] = prog.integrals.get("kineticenergy")
        K = len(phys["average_fields"])
        out["avg"] = prog.averages((K,) + u0.shape[1:]) if K else None
        rec.setup_s = phases["checked steps"] = time.perf_counter() - T0

        # the window
        n = int(cell.traffic["chunk_steps"])
        spans.spans, chunks, failed = [], [], 0
        i, prof = check.CHECKED_STEPS, None
        tw = time.perf_counter()
        while True:
            traced = trace and not chunks and prog.on_card
            if traced:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
                spans.profiling = True
            with spans.span("chunk"):
                c0 = time.perf_counter()
                issued = prog.steps(n)
                i += n
                try:
                    prog.monitor(i)
                except FloatingPointError:
                    failed += n
                c1 = time.perf_counter()
            if traced:
                prof.stop()
                spans.profiling = False
                rec.ops, rec.ranges, rec.kinds = tr.device_record(prof)
                prof = None
            chunks.append(dict(steps=n, t0=c0, t1=c1, issued=issued,
                               traced=traced))
            # a traced run keeps an untraced chunk for the host readings
            if failed or (c1 - tw >= seconds
                          and not (trace and len(chunks) < 2)):
                break
        rec.window_s = c1 - tw
        rec.steps = sum(c["steps"] for c in chunks)
        rec.chunks, rec.spans = chunks, spans.spans
        rec.peak_bytes = peak.read() if prog.on_card else None
        finite = (not failed and np.isfinite(prog.rows[-1]).all()
                  and np.isfinite(out["u"]).all())
        if trace and "boundary_us_per_stage" in cell.per_layer \
                and prog.on_card:
            rec.boundary_us = boundary_step(prog)
        prog.close()
        del prog, s
    phases["window and freeing"] = time.perf_counter() - T0

    # the reference, once the window has closed and the program is freed
    ref = advance(deck, box, u0, check.CHECKED_STEPS,
                  torch.device("cuda", 0) if device == "cuda" else "cpu")
    phases["reference"] = time.perf_counter() - T0
    values = check.numbers(u0, out, ref, phys["average_fields"])
    limits = cell.config["limits"]
    correct = bool(finite and check.verdict(values, limits))

    from . import spec
    names = cell.per_layer if trace else cell.e2e
    metrics = {}
    for name in names:
        v = spec.reader(name)(rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": cell.units[name]}
    result = {"correct": correct, "attempted": rec.steps, "failed": failed,
              "metrics": metrics, "device": device_info(rec)}
    if trace and rec.ops is not None:
        result["breakdown"] = breakdown(rec)
    result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in values.items()}
    phases["readings"] = time.perf_counter() - T0
    lines = []
    if rec.ops is not None:
        lines.append(f"trace events by (device, activity): "
                     f"{dict(rec.kinds)}")
    lines += [f"set-up: seconds from the start at the end of each phase "
             f"{json.dumps(phases)}; solver constructor "
             f"{rec.solver_init_s!r}, first run {rec.capture_s!r}; window "
             f"{rec.window_s!r} s, {len(rec.chunks)} chunks: wall "
             f"{[round(c['t1'] - c['t0'], 4) for c in rec.chunks]} s, run "
             f"issued in {[round(c['issued'], 4) for c in rec.chunks]} s"]
    lines += [f"check {k}: {v!r} (limit {limits.get(k)!r})"
              for k, v in values.items()]
    lines.append(f"check finite: {finite}")
    return result, lines


def boundary_step(prog):
    """Device microseconds a RK stage spends in the boundary stage: one
    eager step, traced, with the boundary functions inside profiler
    ranges (trace.annotate); the kernels launched there, over the
    stages."""
    from torch.profiler import ProfilerActivity, profile

    from . import trace as tr
    s = prog.solver
    fns = s._bc_fns
    if fns is None:
        return None
    tr.annotate(fns, ("ghost_state", "ldg_solution", "inv_common_flux",
                      "visc_common_flux"), tr.BOUNDARY)
    dt = s.compute_dt()
    s.run(1, dt=dt, graph=False)
    prog.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.run(1, dt=dt, graph=False)
        prog.sync()
    return tr.boundary_us(prof.events()) / s.n_stages


def device_info(rec):
    import torch
    out = {"platform": "gpu" if rec.device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if rec.device == "cuda"
                    else "cpu"),
           "count": rec.chips, "memory_peak_bytes": rec.peak_bytes}
    if rec.ops is not None:
        from . import trace as tr
        win = [r for r in rec.ranges if r.name == "chunk"][0]
        busy = [tr.busy_seconds([o for o in rec.ops if o.card == c])
                for c in sorted({o.card for o in rec.ops})]
        out["busy_s"] = sum(busy) / rec.chips
        out["window_s"] = win.end - win.start
    return out


def breakdown(rec):
    """The traced chunk's device time by kernel class, and its longest
    idle gaps by the host span they fell in, summed (card 0's)."""
    import collections

    from . import trace as tr
    by_class = collections.Counter()
    for o in rec.ops:
        by_class[tr.kernel_class(o.name)] += o.end - o.start
    win = [r for r in rec.ranges if r.name == "chunk"][0]
    gaps = collections.Counter()
    card0 = min(o.card for o in rec.ops)
    for name, sec in tr.idle_gaps([o for o in rec.ops if o.card == card0],
                                  [r for r in rec.ranges
                                   if r.name != "chunk"],
                                  win.start, win.end):
        gaps[name] += sec
    return {"device_ops": [[k, v] for k, v in by_class.most_common(10)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(10)]}


def main(argv=None):
    args = parse(argv)
    from . import spec
    try:
        cell = spec.Cell(spec.load(), args.workload)
        cards_or_fail(cell.chips)
        result, lines = run_cell(cell, args.seed, args.seconds, args.trace)
    except Fail as e:
        print(f"bench_h100: {e}", file=sys.stderr)
        return 2
    found = jax_modules()
    if found:
        print(f"bench_h100: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
