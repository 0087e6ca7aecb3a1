"""90th percentile of the per-step walls (ms); each step ends in a device
synchronize in the sweep's observer."""

import statistics


def read(run):
    walls = [s["wall"] for s in run.steps]
    if len(walls) < 2:
        return None
    return 1e3 * statistics.quantiles(walls, n=10)[8]
