"""Shared set-up of the benchmark's CPU tests: the harness on the path and
each cell cut to a size the CPU holds (n = 371, two steps)."""

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbench import harness  # noqa: E402

CELLS = ("rail79841-dia.ros1-sweep", "rail79841-bell.ros2-sweep", "rail79841-dia.newton")
TINY_N = 371
SEED = 2**31 + 12345


def tiny(cell: str):
    """(config, traffic, limits) of ``cell`` at n = 371; sweeps cut to two
    steps at a capacity that holds every column."""
    _, config, traffic, limits = harness.cell_files(cell)
    config = dict(config, n=TINY_N)
    traffic = dict(traffic)
    if traffic["request"] != "gare_newton":
        t0 = traffic["tspan"][0]
        traffic["tspan"] = [t0, t0 + 2 * traffic["dt"]]
        traffic["capacity"] = 160
    return config, traffic, limits


def run_tiny(cell: str, traced: bool = False, seconds: float = 0.1, **kw):
    config, traffic, limits = tiny(cell)
    metrics = harness.metric_names(cell, traced)
    return harness.run_cell(cell, SEED, seconds, traced, t0=time.perf_counter(),
                            device="cpu", config=config, traffic=traffic, limits=limits,
                            metrics=metrics, **kw)
