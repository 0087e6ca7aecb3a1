"""Krylov iterations per Rosenbrock step (each one host read), from the
program's ``ops.blocklinear.krylov_iterations``."""

KEY = "ops.blocklinear.krylov_iterations"


def read(run):
    n = len(run.steps)
    return run.counters[KEY] / n if n and KEY in run.counters else None
