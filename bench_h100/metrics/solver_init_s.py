"""solver_init_s: host seconds of the solver's constructor, the cards
waited for (config, mesh, operators, geometry, Solver.__init__ or
ShardedSolver.__init__)."""


def read(rec):
    return rec.solver_init_s
