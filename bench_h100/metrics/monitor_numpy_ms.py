"""monitor_numpy_ms: host milliseconds per monitor row, in the untraced
chunks, in the program's spans monitor.norm (the residual's float64
norms) and monitor.integrals (the integral quantities, numpy)."""

from bench_h100.program_trace import per_row_ms, program_record


def read(rec):
    return per_row_ms(rec, program_record(),
                      ("monitor.norm", "monitor.integrals"))
