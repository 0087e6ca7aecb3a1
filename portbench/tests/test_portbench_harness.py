"""A tiny CPU rehearsal of each traffic's request through the whole run
(set-up, window, metrics, trace, check), the run staying JAX-free, and
the controls and faults that must make ``correct`` false."""

import math
import subprocess
import sys

import pytest
import torch

import portbench_tiny as tiny
from pbench import control, requests

# The cells whose kind runs the reference in float32 as a control, and
# every cell with each fault its kind plants.
REFERENCE_CONTROLLED = [c for c in tiny.CELLS if hasattr(tiny.kind(c), "reference_f32")]
FAULTS = [(c, f) for c in tiny.CELLS for f in getattr(tiny.kind(c), "FAULTS", {})]


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_rehearsal(cell, traced):
    res = tiny.run_tiny(cell, traced=traced)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in tiny.harness.metric_names(cell, traced)}
    if traced:
        # On the CPU nothing runs on a device: the trace's metrics are silent.
        assert set(res["metrics"]) <= names and "busy_s" in res["device"]
    else:
        assert set(res["metrics"]) == names - {"peak_gib"}
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert 0 < res["notes"]["window_s"]


def test_the_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "import portbench_tiny as t\n"
        "for c in t.CELLS:\n"
        "    assert t.run_tiny(c)['correct']\n"
        "print(t.harness.forbidden_modules())\n" % str(tiny.BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _numbers_fail(numbers, limits):
    return any(not math.isfinite(v) or v > limits[k]["limit"] for k, v in numbers.items())


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_program_f32_control_fails(cell):
    config, traffic, limits = tiny.tiny(cell)
    inputs = requests.build_inputs(config, tiny.SEED)
    numbers, record = control.program_f32(config, traffic, inputs, "cpu")
    # A float32 run that raises has failed as well.
    assert numbers is None or _numbers_fail(numbers, limits), numbers
    assert numbers is not None or "error" in record


@pytest.mark.parametrize("cell", REFERENCE_CONTROLLED)
def test_reference_f32_control_fails(cell):
    """The reference run in float32 in the program's place, the other
    control, is far from the float64 reference, where the float64 program
    is close, and fails the cell's limits."""
    config, traffic, limits = tiny.tiny(cell)
    inputs = requests.build_inputs(config, tiny.SEED)
    numbers = control.reference_f32(config, traffic, inputs, "cpu")
    req = requests.make(config, traffic, inputs, torch.float64, "cpu")
    req.prepare()
    program, _ = req.check([req.run({})], torch.float64, "cpu")
    for k, v in numbers.items():
        assert v > 100 * program[k], (k, v, program[k])
    assert _numbers_fail(numbers, limits), numbers


# --- faults planted in the timed path: each must make `correct` false ----------


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{f}-{c}" for c, f in FAULTS])
def test_fault_is_caught(cell, fault, monkeypatch):
    tiny.kind(cell).FAULTS[fault](monkeypatch)
    assert tiny.run_tiny(cell)["correct"] is False
