"""common_flux_ms_per_step: device milliseconds per replayed step, in the
traced chunk, of the operations that the step's part
residual.common_flux captured (the Riemann and LDG common fluxes,
interior and boundary); program_trace.replay_parts maps each replayed
operation to its part by its place in the step's graph."""

from bench_h100.program_trace import part_ms_per_step, program_record


def read(rec):
    return part_ms_per_step(rec, program_record(), "residual.common_flux")
