"""setup_s: seconds from the process's start to the window's first step:
imports, the inputs, the solver, the warm-up step, the capture and the
checked steps (run.run_cell)."""


def read(rec):
    return rec.setup_s
