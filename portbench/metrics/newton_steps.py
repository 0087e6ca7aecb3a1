"""Newton steps per solve, from the solver's ``info``."""


def read(run):
    solves = [r["newton_steps"] for r in run.requests if "newton_steps" in r]
    return sum(solves) / len(solves) if solves else None
