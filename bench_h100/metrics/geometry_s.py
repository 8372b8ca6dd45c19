"""geometry_s: host seconds of the solver's operators and element
geometry at set-up, the program's own span setup.geometry (build_ops,
build_element_block)."""

from bench_h100.program_trace import program_record, setup_seconds


def read(rec):
    return setup_seconds(program_record(), "setup.geometry")
