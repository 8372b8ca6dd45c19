"""Reading the profiler's trace of a run.

``kernel_class``, ``annotate`` and ``boundary_us`` are copies of
scripts/profile_torch_tgv.py's kernel_class, annotate and breakdown (the
part that classes a kernel by the profiler range it was launched in).
``device_record`` reads the raw trace of a traced stretch of the window:
every kernel, memset and copy on every card, and the benchmark's own host
ranges (``bench.<span>``), on one clock, so that a device operation is
placed in the host span it ran under and an idle gap named by the span
the host was in.
"""

from __future__ import annotations

import collections
import functools

BOUNDARY = "boundary stage"


def kernel_class(name):
    n = name.lower()
    if "volume_tdisf" in n:
        return "volume kernel (hand CUDA)"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "cublas" in n:
        return "GEMM (cuBLAS)"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather / indexed store"
    return "other elementwise"


def annotate(obj, names, label):
    """Run the methods ``names`` of ``obj`` inside a profiler range named
    ``label``."""
    import torch

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return inner
    for name in names:
        setattr(obj, name, wrap(getattr(obj, name)))


def boundary_us(events):
    """Device microseconds of the kernels launched inside a BOUNDARY range,
    from the profiler's events (a kernel is linked to the op that launched
    it, and the op to the ranges around it)."""
    total = 0.0
    for ev in events:
        kernels = getattr(ev, "kernels", None) or []
        parent = ev if kernels else None
        while parent is not None and parent.name != BOUNDARY:
            parent = parent.cpu_parent
        if parent is not None:
            total += sum(k.duration for k in kernels)
    return total


DeviceOp = collections.namedtuple("DeviceOp", "card name start end nbytes")
HostRange = collections.namedtuple("HostRange", "name start end")


def device_record(prof):
    """(device ops, host ranges, kinds) of a profiler session, times in
    seconds from the trace's start: every kernel, memset and copy on a
    card as DeviceOp(card, name, start, end, bytes or None), every
    ``bench.<span>`` range on the host as HostRange(span, start, end), and
    the count of the trace's events by (device type, activity)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, ranges = [], []
    kinds = collections.Counter()
    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    for e in results.events():
        name = e.name()
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        on_card = e.device_type() == cuda
        kinds[(str(e.device_type()), kind)] += 1
        start = (e.start_ns() - base) * 1e-9
        end = start + e.duration_ns() * 1e-9
        if name.startswith("bench."):
            if not on_card:
                ranges.append(HostRange(name[len("bench."):], start, end))
        elif on_card and "annotation" not in kind:
            nb = e.nbytes() if hasattr(e, "nbytes") else 0
            ops.append(DeviceOp(e.device_index(), name, start, end,
                                nb or None))
    return ops, ranges, kinds


def within(ops, ranges, span):
    """The device ops that started inside a host range named ``span``."""
    rs = [(r.start, r.end) for r in ranges if r.name == span]
    return [o for o in ops if any(a <= o.start <= b for a, b in rs)]


def busy_intervals(ops):
    """The union of the ops' [start, end] intervals, sorted."""
    out = []
    for a, b in sorted((o.start, o.end) for o in ops):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(ops):
    return sum(b - a for a, b in busy_intervals(ops))


def idle_gaps(ops, ranges, t0, t1):
    """The gaps in the device's busy intervals within [t0, t1], each named
    by the host range holding its midpoint ("other" where none does):
    [(name, seconds)]."""
    gaps, cur = [], t0
    for a, b in busy_intervals(ops):
        if a > cur:
            gaps.append((cur, min(a, t1)))
        cur = max(cur, b)
    if cur < t1:
        gaps.append((cur, t1))
    out = []
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = next((r.name for r in ranges if r.start <= mid <= r.end),
                    "other")
        out.append((name, b - a))
    return out
