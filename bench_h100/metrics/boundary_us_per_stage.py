"""boundary_us_per_stage: device microseconds a RK stage spends in the
boundary stage (solver/bc.py): the kernels launched inside the boundary
functions in one traced eager step after the window (run.boundary_step),
over its stages."""


def read(rec):
    return rec.boundary_us
