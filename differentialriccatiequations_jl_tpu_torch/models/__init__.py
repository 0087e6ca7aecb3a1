"""Solvers: residuals and the Ros1 step."""
