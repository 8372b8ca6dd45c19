"""Operators of the port that act on the state between residual calls."""
