"""Time per Rosenbrock step (ms): the window over all steps of its
completed sweeps, per-sweep set-up inside the window included."""


def read(run):
    n = len(run.steps)
    return 1e3 * run.window_s / n if n else None
