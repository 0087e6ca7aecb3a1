"""Operators and block linear solvers."""
