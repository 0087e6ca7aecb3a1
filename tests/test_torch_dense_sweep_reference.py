"""The port's dense Ros2 GDRE sweep against the benchmark's plain low-rank
reference (``portbench/pbench/reference.py::ros2_sweep``), at n = 371 on
the CPU and at the limits of the benchmark's dense cell
(``rail5177-dense.ros2-sweep``): the sweep runs through the public
``solve`` as the cell's request kind drives it, and the kind's check
judges it.  Also: each fault the kind plants fails that comparison, the
sign iteration's counters and spans, and the sweep's outputs under the
benchmark's ranges.  Imports no JAX."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from pbench import harness, requests  # noqa: E402

from differentialriccatiequations_jl_tpu_torch.models import lyapunov_dense  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils import timers  # noqa: E402

CELL = "rail5177-dense.ros2-sweep"
N = 371
SEEDS = (2**31 + 18, 5177)
STEPS = 2  # the kind's CPU cut
_SIGN, _REPLAY = lyapunov_dense._sign_iteration, lyapunov_dense._replay_rhs


def _request(seed):
    """The cell's request at n = 371, cut by its kind to two steps, prepared
    on the CPU; and the cell's limits."""
    _, config, traffic, limits = harness.cell_files(CELL)
    kind = requests.kind(traffic)
    config, traffic = kind.tiny(dict(config, n=N), traffic)
    req = kind.make(config, traffic, requests.build_inputs(config, seed), torch.float64, "cpu")
    req.prepare()
    return req, limits


def _fails(numbers, limits):
    return any(not math.isfinite(v) or v > limits[k]["limit"] for k, v in numbers.items())


@pytest.mark.parametrize("seed", SEEDS)
def test_dense_sweep_matches_the_low_rank_reference(seed):
    req, limits = _request(seed)
    record = {}
    out = req.run(record)
    assert record["attempted"] == STEPS and record["failed"] == 0
    assert len(out["K"]) == STEPS + 1 and out["X"].shape == (N, N)
    numbers, notes = req.check([out], torch.float64, "cpu")
    assert set(numbers) == {"k_gap", "x_gap"}
    assert not _fails(numbers, limits), (numbers, limits)
    assert notes["compared"] == 1


@pytest.mark.parametrize("fault", ["unchanged_state", "altered_answer", "short_sign"])
def test_planted_fault_fails_the_comparison(fault, monkeypatch):
    req, limits = _request(SEEDS[0])
    requests.kind(req.traffic).FAULTS[fault](monkeypatch)
    numbers, _ = req.check([req.run({})], torch.float64, "cpu")
    assert _fails(numbers, limits), (fault, numbers)


def test_short_sign_leaves_the_sign_function_unconverged():
    """The `short_sign` fault's count leaves the first step's iterate more
    than 1e-2 from −I, where the program's 40 steps reach it."""
    req, _ = _request(SEEDS[0])
    short = requests.kind(req.traffic).SHORT_SIGN
    Ed, Ad, B, X0 = req.prob.E.M, req.prob.A.M, req.prob.B, req.prob.X0
    K = (B.T @ X0) @ Ed
    gamma = 1.0 + 1.0 / math.sqrt(2.0)
    gF = gamma * req.tau * (Ad - B @ K) - Ed / 2.0
    M = torch.linalg.solve(Ed.T, gF.T).T
    eye = torch.eye(N, dtype=torch.float64)

    def off(k):
        return float(torch.linalg.norm(lyapunov_dense._sign_iteration(M, k)[0] + eye)) / N**0.5

    assert off(short) > 1e-2 and off(40) < 1e-12


def test_counters_read_40_sign_and_80_replay_iterations_a_step():
    req, _ = _request(SEEDS[0])
    sign0, replay0 = lyapunov_dense.sign_iterations, lyapunov_dense.replay_iterations
    req.run({})
    assert lyapunov_dense.sign_iterations - sign0 == 40 * STEPS
    assert lyapunov_dense.replay_iterations - replay0 == 80 * STEPS


def test_spans_present_when_timers_enabled():
    req, _ = _request(SEEDS[0])
    timers.reset()
    timers.enable(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            req.run({})
        report = timers.report()
    finally:
        timers.enable(False)
        timers.reset()
    assert report["lyapunov_dense.sign_cache"][1] == STEPS
    assert report["lyapunov_dense.solve"][1] == 2 * STEPS
    names = {e.name for e in prof.events()}
    assert {"lyapunov_dense.sign_cache", "lyapunov_dense.solve"} <= names


def test_outputs_bitwise_equal_under_the_benchmark_ranges():
    """The benchmark's ``portbench.sign`` and ``portbench.replay`` ranges
    wrap the program's functions and change none of its outputs."""
    req, _ = _request(SEEDS[1])
    plain = req.run({})
    run = harness.Run(CELL, req.config, req.traffic)
    readers = [harness.load_reader(m) for m in ("sign_peak_pct", "replay_peak_pct")]
    with readers[0].instrument(run), readers[1].instrument(run):
        wrapped = req.run({})
        assert lyapunov_dense._sign_iteration is not _SIGN
    assert lyapunov_dense._sign_iteration is _SIGN and lyapunov_dense._replay_rhs is _REPLAY
    assert len(plain["K"]) == len(wrapped["K"]) == STEPS + 1
    for a, b in zip(plain["K"], wrapped["K"]):
        assert np.array_equal(a, b)
    assert np.array_equal(plain["X"], wrapped["X"])
    calls = run.meter.calls
    assert calls["portbench.sign"]["calls"] == STEPS
    assert calls["portbench.replay"]["calls"] == 2 * STEPS
    assert calls["portbench.sign"]["flops"] == STEPS * 40 * 8 * N**3 // 3
    assert calls["portbench.replay"]["flops"] == 2 * STEPS * 40 * 4 * N**3

