"""monitor_copy_ms: host milliseconds per monitor row, in the untraced
chunks, in the program's span monitor.to_host: the wait for the row's
residual and the copies of the residual and of the state to the host,
with their (E, U, F) transposes."""

from bench_h100.program_trace import per_row_ms, program_record


def read(rec):
    return per_row_ms(rec, program_record(), ("monitor.to_host",))
