"""Solver orchestration on torch: element blocks, residual, time stepping."""

from .solver import Solver

__all__ = ["Solver"]
