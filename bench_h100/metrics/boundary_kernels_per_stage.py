"""boundary_kernels_per_stage: the device operations of the traced
chunk's replayed steps that the step's part residual.boundary captured,
per RK stage (program_trace.replay_parts: each replayed operation mapped
to its part by its place in the step's graph).  None where the step has
no such part."""

from bench_h100.program_trace import program_record, replay_parts


def read(rec):
    got = replay_parts(rec, program_record())
    if got is None or "residual.boundary" not in got[0]:
        return None
    ops, steps = got
    return len(ops["residual.boundary"]) / (steps * rec.n_stages)
