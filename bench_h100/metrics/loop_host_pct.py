"""loop_host_pct: the share of the untraced chunks' wall time that the
host spends in the driver loop's work between the steps: compute_dt, the
monitor row, the mass-flux line and, on several cards, sync_twin."""

from bench_h100.metrics.common import LOOP_SPANS, host_seconds, untraced


def read(rec):
    chunks = untraced(rec)
    wall = sum(c["t1"] - c["t0"] for c in chunks)
    if not wall:
        return None
    return 100.0 * host_seconds(rec, LOOP_SPANS, chunks) / wall
