"""Shared set-up of the benchmark's CPU tests: the harness on the path and
every cell of ``BENCHMARK.json`` cut to a size the CPU holds (n = 371,
then its request kind's own cut)."""

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbench import harness, requests  # noqa: E402

CELLS = tuple(w["name"] for w in harness.manifest()["workloads"])
TINY_N = 371
SEED = 2**31 + 12345


def kind(cell: str):
    """The module of ``cell``'s request kind."""
    return requests.kind(harness.cell_files(cell)[2])


def tiny(cell: str):
    """(config, traffic, limits) of ``cell`` at n = 371, then cut by its
    kind's ``tiny`` where it has one (the sweeps: two steps at a capacity
    that holds every column)."""
    _, config, traffic, limits = harness.cell_files(cell)
    config = dict(config, n=TINY_N)
    cut = getattr(requests.kind(traffic), "tiny", None)
    if cut is not None:
        config, traffic = cut(config, traffic)
    return config, traffic, limits


def run_tiny(cell: str, traced: bool = False, seconds: float = 0.1, **kw):
    config, traffic, limits = tiny(cell)
    metrics = harness.metric_names(cell, traced)
    return harness.run_cell(cell, SEED, seconds, traced, t0=time.perf_counter(),
                            device="cpu", config=config, traffic=traffic, limits=limits,
                            metrics=metrics, **kw)
