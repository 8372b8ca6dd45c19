"""boundary_ms_per_step: device milliseconds per replayed step, in the
traced chunk, of the operations that the step's part residual.boundary
captured (the boundary faces' states, ghost states and LDG common
solution, the reads of their gradient and their common flux, solver/bc.py
and models/wall_model.py); program_trace.replay_parts maps each replayed
operation to its part by its place in the step's graph.  None where the
step has no such part (no boundary faces, or a program that does not
mark it)."""

from bench_h100.program_trace import part_ms_per_step, program_record


def read(rec):
    return part_ms_per_step(rec, program_record(), "residual.boundary")
