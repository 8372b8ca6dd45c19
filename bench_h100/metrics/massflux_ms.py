"""massflux_ms: host milliseconds per monitor row, in the untraced
chunks, in the program's span massflux (Solver.inflow_massflux, the
mass-flux line of a body-forced run).  None without forcing."""

from bench_h100.program_trace import per_row_ms, program_record


def read(rec):
    return per_row_ms(rec, program_record(), ("massflux",))
