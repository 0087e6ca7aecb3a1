"""Timer registry and trace annotations (port of the JAX package's
``utils/timers.py``).

Host-side phases aggregate into a process-wide registry when enabled
(`enable`); every `timeit` section is also a `torch.profiler` range
(`record_function`), so a profile of a solve shows the ADI's phases by
name.  Timing is off by default.  Sections time the host: a phase whose
device work is still queued when it ends is charged to the first later
phase that waits for the card.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from torch.profiler import record_function

_ENABLED = False
_TIMES: dict = defaultdict(lambda: [0.0, 0])


def enable(flag: bool = True) -> None:
    global _ENABLED
    _ENABLED = flag


def reset() -> None:
    _TIMES.clear()


def report() -> dict:
    """``{section: (total_seconds, ncalls)}``"""
    return {k: tuple(v) for k, v in _TIMES.items()}


@contextlib.contextmanager
def timeit(name: str):
    """Time a host-side section (when enabled) and mark it in the trace."""
    if not _ENABLED:
        with record_function(name):
            yield
        return
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        rec = _TIMES[name]
        rec[0] += time.perf_counter() - t0
        rec[1] += 1
