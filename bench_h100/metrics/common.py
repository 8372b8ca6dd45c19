"""What several metric readers share: the window's host spans and chunks,
and the traced chunk's device operations."""

from __future__ import annotations

from .. import trace as tr

LOOP_SPANS = ("compute_dt", "monitor", "massflux", "sync_twin")


def untraced(rec):
    """The window's chunks that ran without the profiler."""
    return [c for c in rec.chunks if not c["traced"]]


def host_seconds(rec, names, chunks):
    """Host seconds in the spans ``names`` inside ``chunks``."""
    return sum(b - a for n, a, b in rec.spans if n in names
               and any(c["t0"] <= a <= c["t1"] for c in chunks))


def replay_ops(rec):
    """The traced chunk's device operations issued by ``run`` (the
    replays of the captured step), or None without a trace."""
    if rec.ops is None:
        return None
    return tr.within(rec.ops, rec.ranges, "run")


def traced_steps(rec):
    return sum(c["steps"] for c in rec.chunks if c["traced"])
