"""Operators of the port: the numpy operator builders copied from
hifiles_tpu/ops (basis, quadrature, correction functions, simplex bases,
the per-element-type factory, LES filters) and the torch operators that act
on the state between residual calls (stabilization)."""
