"""Sign-iteration M-steps per Rosenbrock step, from the program's
``models.lyapunov_dense.sign_iterations`` over the window's steps: the
fixed 40 of one cache build a dense Ros2 step; an iteration that stopped
early would read fewer.  Silent where the program has no such counter."""

KEY = "models.lyapunov_dense.sign_iterations"


def read(run):
    n = len(run.steps)
    return run.counters[KEY] / n if n and KEY in run.counters else None
