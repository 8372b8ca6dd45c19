"""issue_ms_per_step: host milliseconds from a chunk's ``run`` call to its
return, before the cards finish, per step, over the untraced chunks."""

from bench_h100.metrics.common import untraced


def read(rec):
    chunks = untraced(rec)
    steps = sum(c["steps"] for c in chunks)
    if not steps:
        return None
    return 1e3 * sum(c["issued"] for c in chunks) / steps
