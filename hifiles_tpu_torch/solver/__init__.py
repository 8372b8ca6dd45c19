"""Solver orchestration on torch: element blocks, residual, time stepping."""

from .multiblock import MixedSolver
from .solver import Solver

__all__ = ["MixedSolver", "Solver"]
