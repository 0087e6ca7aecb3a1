"""Time to a converged stationary gain (s): the window over its completed
Newton solves."""


def read(run):
    n = sum(1 for r in run.requests if "newton_steps" in r)
    return run.window_s / n if n else None
