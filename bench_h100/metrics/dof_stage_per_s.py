"""dof_stage_per_s: DOF x RK stages x steps over the whole window, over
the window's wall time from its start to the wait after its last chunk's
monitor row: every chunk's steps and the host work between them."""


def read(rec):
    return rec.dof * rec.n_stages * rec.steps / rec.window_s
