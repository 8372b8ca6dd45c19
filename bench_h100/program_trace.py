"""Reading the program's own spans and counters (hifiles_tpu_torch.tracing)
beside the benchmark's record.

The program records its spans in memory on the host clock that
``time.perf_counter_ns`` reads, the clock of the benchmark's own spans
(``rec.spans``) and chunks (``rec.chunks``); a traced chunk's device
operations and the benchmark's host ranges (``rec.ops``, ``rec.ranges``)
are on the profiler's clock.  Here:

- ``program_record``: the program's record, or None for a program
  without the tracing module;
- ``clock_offset``: what separates the two clocks, from the benchmark's
  spans inside the traced chunk (``compute_dt``, ``run``, ``monitor``)
  on both, checked against each of them (None past ``ALIGN_S``);
- ``replay_parts``: the traced replays' device operations split into
  steps and mapped by their place in the step's graph to the part of the
  step that captured them (tracing.part), None unless every replay ran
  exactly the captured graph's nodes (by position: no clock needed);
- ``idle_gaps``: the traced chunk's idle gaps, each named by the
  innermost program span that holds its midpoint;
- ``report``: all of it, for a breakdown by hand (PERF.md).

Each returns None where the run gave it nothing, and never raises for a
program that lacks the spans.
"""

from __future__ import annotations

import collections

from . import trace as tr
from .metrics.common import replay_ops, traced_steps, untraced

ALIGN_S = 100e-6      # the most the two clocks may disagree on a span


def program_record():
    """The program's tracing record (tracing.record()), or None where the
    program has no tracing module."""
    try:
        from hifiles_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.record()


def setup_seconds(prog, name):
    """The aggregate seconds of the program's span ``name``, or None."""
    if prog is None or name not in prog["totals"]:
        return None
    return prog["totals"][name][1] * 1e-9


def _in_chunks(start_ns, chunks):
    t = start_ns * 1e-9
    return any(c["t0"] <= t <= c["t1"] for c in chunks)


def per_row_ms(rec, prog, names):
    """Host milliseconds in the program's spans ``names`` per monitor row
    (its ``monitor`` span) in the untraced chunks, or None."""
    if prog is None:
        return None
    chunks = untraced(rec)
    spans = [s for s in prog["spans"] if _in_chunks(s.start_ns, chunks)]
    rows = sum(1 for s in spans if s.name == "monitor")
    parts = [s for s in spans if s.name in names]
    if not rows or not parts:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in parts) / rows


def _traced_chunk_span(rec):
    """The benchmark's ``chunk`` span (host clock) of the traced chunk."""
    traced = [c for c in rec.chunks if c["traced"]]
    if not traced:
        return None
    c0 = traced[0]["t0"]
    return next((s for s in rec.spans
                 if s[0] == "chunk" and s[1] <= c0 <= s[2]), None)


def clock_deviations(rec):
    """(offset, deviations): ``offset``, seconds to add to a host-clock
    time of the traced chunk to place it on the trace's clock; for each
    of the benchmark's spans inside the chunk (compute_dt, run, the
    monitor row), (name, seconds by which its range's start lands off its
    start on the host plus ``offset``).  None without a trace or the
    chunk's span.

    A span's range opens just before its host start, by what entering a
    profiler range costs, tens of microseconds; so the offset is the
    median of the spans' start differences.  The chunk's own span is
    left out: its range is the first the profiler opens, which costs
    ~0.1 ms more.  A range's end is not used: leaving one costs up to
    half a millisecond under the profiler."""
    if rec.ops is None:
        return None
    host = _traced_chunk_span(rec)
    if host is None:
        return None
    pairs = []
    for name in sorted({s[0] for s in rec.spans if s[0] != "chunk"
                        and host[1] <= s[1] <= host[2]}):
        hs = sorted(s[1] for s in rec.spans
                    if s[0] == name and host[1] <= s[1] <= host[2])
        rs = sorted(r.start for r in rec.ranges if r.name == name)
        if len(hs) != len(rs):
            return None
        pairs += [(name, r - h) for h, r in zip(hs, rs)]
    if not pairs:
        return None
    diffs = sorted(d for _, d in pairs)
    offset = diffs[len(diffs) // 2]
    return offset, [(name, d - offset) for name, d in pairs]


def clock_offset(rec):
    """clock_deviations' offset, or None where one start lands more than
    ALIGN_S off it, or fewer than two spans fix it."""
    got = clock_deviations(rec)
    if (got is None or len(got[1]) < 2
            or max(abs(d) for _, d in got[1]) > ALIGN_S):
        return None
    return got[0]


def replay_parts(rec, prog):
    """The traced chunk's replayed steps by part: (ops by part, steps),
    ops by part a dict part -> [DeviceOp] of every traced replay.

    The replays are the last steps x N device operations that ``run``
    issued (N the nodes of the capture the chunk replays, the last one
    before it; what ``run`` issues before its first replay, such as dt's
    copy, comes first), in order of their start; each replay's i-th
    operation is the graph's node i, which the part whose node range
    holds i captured.  None without a trace or a capture, on more than
    one card, or unless every replay ran N operations with the first
    replay's kernel names in the first replay's order."""
    ops = replay_ops(rec)
    if not ops or prog is None or len({o.card for o in ops}) != 1:
        return None
    host = _traced_chunk_span(rec)
    caps = [c for c in prog["captures"]
            if host is not None and c["start_ns"] * 1e-9 < host[1]]
    if not caps:
        return None
    cap = caps[-1]
    N, steps = cap["nodes"], traced_steps(rec)
    label = [None] * N
    for name, a, b in cap["parts"]:
        label[a:b] = [name] * (b - a)
    extra = len(ops) - steps * N
    if N == 0 or None in label or not 0 <= extra < N:
        return None
    body = sorted(ops, key=lambda o: (o.start, o.end))[extra:]
    first = [o.name for o in body[:N]]
    for k in range(1, steps):
        if [o.name for o in body[k * N:(k + 1) * N]] != first:
            return None
    out = collections.defaultdict(list)
    for i, o in enumerate(body):
        out[label[i % N]].append(o)
    return dict(out), steps


def part_ms_per_step(rec, prog, part):
    """Device milliseconds a replayed step spends in the operations that
    ``part`` captured, or None."""
    got = replay_parts(rec, prog)
    if got is None or part not in got[0]:
        return None
    ops, steps = got
    return 1e3 * sum(o.end - o.start for o in ops[part]) / steps


def _program_ranges(rec, prog, offset):
    """The program's spans within the traced chunk as ranges on the
    trace's clock, innermost first for any point (latest start first)."""
    host = _traced_chunk_span(rec)
    out = [tr.HostRange(s.name, s.start_ns * 1e-9 + offset,
                        s.end_ns * 1e-9 + offset)
           for s in prog["spans"]
           if s.end_ns * 1e-9 >= host[1] and s.start_ns * 1e-9 <= host[2]]
    return sorted(out, key=lambda r: (-r.start, r.end))


def idle_gaps(rec, prog):
    """[(span, seconds)]: the traced chunk's idle gaps on its first card,
    each named by the innermost program span holding its midpoint
    ("other" where none does), summed by span; None without a trace, a
    program record or the clocks' alignment."""
    offset = clock_offset(rec)
    if offset is None or prog is None:
        return None
    win = [r for r in rec.ranges if r.name == "chunk"][0]
    card0 = min(o.card for o in rec.ops)
    gaps = collections.Counter()
    for name, sec in tr.idle_gaps([o for o in rec.ops if o.card == card0],
                                  _program_ranges(rec, prog, offset),
                                  win.start, win.end):
        gaps[name] += sec
    return gaps.most_common()


def report(rec, prog):
    """Everything above for one run, as a dict for a breakdown by hand:
    set-up seconds by ``setup.*`` span; per monitor row, host ms by
    ``monitor.*`` span (untraced chunks); per replayed step, device ms by
    part and by kernel class within it; the idle gaps by innermost
    program span; the clocks' alignment and the capture's node count."""
    if prog is None:
        return None
    out = {"setup_s": {k: v[1] * 1e-9 for k, v in prog["totals"].items()
                       if k == "setup" or k.startswith("setup.")},
           "monitor_ms_per_row": {
               k: per_row_ms(rec, prog, (k,))
               for k in sorted({s.name for s in prog["spans"]
                                if s.name.startswith("monitor")})},
           "clock_deviation_s": (clock_deviations(rec) or (None, None))[1],
           "captured_nodes": prog["counters"].get("captured_nodes")}
    got = replay_parts(rec, prog)
    if got is not None:
        ops, steps = got
        out["replay_ms_per_step"] = {
            part: {"ms": 1e3 * sum(o.end - o.start for o in part_ops)
                   / steps,
                   "ops": len(part_ops) // steps,
                   "by_class": {c: 1e3 * sum(o.end - o.start
                                             for o in part_ops
                                             if tr.kernel_class(o.name) == c)
                                / steps
                                for c in sorted({tr.kernel_class(o.name)
                                                 for o in part_ops})}}
            for part, part_ops in ops.items()}
    out["idle_gaps_s"] = idle_gaps(rec, prog)
    return out
