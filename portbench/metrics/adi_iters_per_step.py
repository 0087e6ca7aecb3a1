"""ADI iterations per Rosenbrock step (both stages of a Ros2 step), from
the sweep observer's ``iters``."""


def read(run):
    steps = run.steps
    return sum(s["iters"] for s in steps) / len(steps) if steps else None
