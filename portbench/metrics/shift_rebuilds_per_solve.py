"""Closed-loop Penzl shift rebuilds per Newton solve: the program's
``models.compiled.shift_rebuilds`` over the window's solves.  Silent where
the program has no such counter."""

KEY = "models.compiled.shift_rebuilds"


def read(run):
    solves = [r for r in run.requests if "newton_steps" in r]
    if not solves or KEY not in run.counters:
        return None
    return run.counters[KEY] / len(solves)
