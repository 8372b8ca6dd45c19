"""k1_roofline_pct: the volume kernel K1's least time for its launch
(roofline.k1_bound_ms: the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s, from the launch's shapes) over its mean
device time per launch in the traced chunk's replayed steps, in percent.
One launch a RK stage and card covers the card's elements."""

from bench_h100.metrics.common import replay_ops
from bench_h100.roofline import k1_bound_ms


def read(rec):
    ops = replay_ops(rec)
    k1 = [o for o in ops or [] if "volume_tdisf" in o.name]
    if not k1:
        return None
    U = (rec.order + 1) ** 3
    E = rec.dof // U // rec.chips
    bound_ms, _ = k1_bound_ms(U, E, sgs=rec.cell.deck().get("LES") == "1",
                              walls=rec.box.walls)
    mean_ms = 1e3 * sum(o.end - o.start for o in k1) / len(k1)
    return 100.0 * bound_ms / mean_ms
