"""The share of the window's closed-loop Penzl shift rebuilds that ran on
the card: the program's ``models.compiled.shift_rebuilds_card`` over its
``models.compiled.shift_rebuilds``.  A run on the card whose rebuilds all
fell back to the host route reads 0.  Silent where the run held no device
memory (a run on the CPU, whose rebuilds all take the host route, as
``peak_gib`` is silent there), where the program has no such counters, or
where no rebuild ran."""

CARD = "models.compiled.shift_rebuilds_card"
ALL = "models.compiled.shift_rebuilds"


def read(run):
    if not run.peak_bytes or CARD not in run.counters or not run.counters.get(ALL):
        return None
    return run.counters[CARD] / run.counters[ALL]
