"""Host seconds of the closed-loop Penzl shift rebuilds per Newton solve
(the program's ``models.compiled.shift_rebuild_seconds``, as a delta)."""

KEY = "models.compiled.shift_rebuild_seconds"


def read(run):
    solves = [r for r in run.requests if "newton_steps" in r]
    if not solves or KEY not in run.counters:
        return None
    return run.counters[KEY] / len(solves)
