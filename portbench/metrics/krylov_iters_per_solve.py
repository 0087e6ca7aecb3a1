"""Krylov iterations per Newton solve, from the program's
``ops.blocklinear.krylov_iterations``."""

KEY = "ops.blocklinear.krylov_iterations"


def read(run):
    n = sum(1 for r in run.requests if "newton_steps" in r)
    return run.counters[KEY] / n if n and KEY in run.counters else None
