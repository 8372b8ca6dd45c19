"""gradient_ms_per_step: device milliseconds per replayed step, in the
traced chunk, of the operations that the step's part residual.gradient
captured (the LDG corrected gradient, the element-side viscous flux at
the flux points and its reads); program_trace.replay_parts maps each
replayed operation to its part by its place in the step's graph."""

from bench_h100.program_trace import part_ms_per_step, program_record


def read(rec):
    return part_ms_per_step(rec, program_record(), "residual.gradient")
