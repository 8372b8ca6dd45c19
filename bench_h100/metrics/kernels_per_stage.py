"""kernels_per_stage: the device kernels, memsets and copies of the traced
chunk's replayed steps, per RK stage, the largest over the cards."""

import collections

from bench_h100.metrics.common import replay_ops, traced_steps


def read(rec):
    ops = replay_ops(rec)
    if not ops:
        return None
    per_card = collections.Counter(o.card for o in ops)
    return max(per_card.values()) / (traced_steps(rec) * rec.n_stages)
