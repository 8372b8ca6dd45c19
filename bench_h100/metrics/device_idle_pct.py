"""device_idle_pct: the share of the traced chunk (its host span, from
compute_dt to the monitor row's end) in which a card runs no kernel,
memset or copy, the largest over the cards."""

from bench_h100 import trace as tr


def read(rec):
    if rec.ops is None:
        return None
    win = [r for r in rec.ranges if r.name == "chunk"][0]
    span = win.end - win.start
    idle = []
    for card in sorted({o.card for o in rec.ops}):
        ops = [o for o in rec.ops if o.card == card
               and o.start < win.end and o.end > win.start]
        idle.append(1.0 - tr.busy_seconds(ops) / span)
    return 100.0 * max(idle)
