"""The readers of the Newton's closed-loop shift rebuild counters,
``shift_rebuilds_per_solve`` and ``shift_rebuild_card_share``, on
hand-made runs: what each reads, and where each stays silent."""

import pytest

import portbench_tiny  # noqa: F401  (puts the harness on the path)
from pbench import harness


class _Run:
    def __init__(self, counters, solves=2, peak_bytes=2**33):
        self.counters = counters
        self.requests = [{"newton_steps": 33} for _ in range(solves)]
        self.peak_bytes = peak_bytes


@pytest.mark.parametrize("counters, peak_bytes, per_solve, card_share", [
    ({"models.compiled.shift_rebuilds": 10, "models.compiled.shift_rebuilds_card": 10},
     2**33, 5.0, 1.0),
    ({"models.compiled.shift_rebuilds": 10, "models.compiled.shift_rebuilds_card": 4},
     2**33, 5.0, 0.4),
    # On the card, every rebuild fell back to the host route: the share reads 0.
    ({"models.compiled.shift_rebuilds": 10, "models.compiled.shift_rebuilds_card": 0},
     2**33, 5.0, 0.0),
    # On the CPU (no device memory held), or where no rebuild ran: silent.
    ({"models.compiled.shift_rebuilds": 10, "models.compiled.shift_rebuilds_card": 0},
     0, 5.0, None),
    ({"models.compiled.shift_rebuilds": 0, "models.compiled.shift_rebuilds_card": 0},
     2**33, 0.0, None),
    # A program without the counters: both are silent.
    ({"models.compiled.shift_rebuild_seconds": 1.5}, 2**33, None, None),
])
def test_shift_rebuild_readers(counters, peak_bytes, per_solve, card_share):
    run = _Run(counters, peak_bytes=peak_bytes)
    assert harness.load_reader("shift_rebuilds_per_solve").read(run) == per_solve
    assert harness.load_reader("shift_rebuild_card_share").read(run) == card_share
    assert harness.load_reader("shift_rebuilds_per_solve").read(_Run(counters, 0)) is None
