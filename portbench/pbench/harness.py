"""One run of one cell: set-up, the measured window, the metrics, the check
against the plain reference, and the result line.

Everything about a cell is found by name: the workload and its
configuration in ``BENCHMARK.json``, the configuration's sizes in its
``file``, the traffic mix in ``portbench/traffic/<traffic>.json``, the
limits of the comparison in ``portbench/limits/<cell>.json`` and each
metric's reader in ``portbench/metrics/<metric>.py`` (a ``read(run)`` that
returns a number or ``None``, and optionally an ``instrument(run)`` context
manager entered around the traced request).  A metric ``<name>.<suffix>``
without a file of its own is read by ``<name>.py``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import counters, requests, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "differentialriccatiequations_jl_tpu")


class Run:
    """What a run measured, handed to the metric readers."""

    def __init__(self, cell: str, config: dict, traffic: dict):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.setup_s = math.nan
        self.window_s = math.nan
        self.requests = []       # per counted request: wall, steps or solve data, counters
        self.untraced_walls = []  # walls of requests run before the profiler started
        self.counters = {}       # deltas over the counted requests
        self.peak_bytes = 0
        self.trace = None        # summary of the traced request (`trace.reduce_events`)
        self.meter = trace.Meter()

    @property
    def steps(self) -> list:
        return [s for r in self.requests for s in r.get("steps", [])]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str):
    """(workload entry, configuration, traffic, limits) of a cell by name."""
    man = manifest()
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{name}.json")
    return w, config, traffic, limits


def metric_names(name: str, trace_on: bool) -> list:
    """The metrics a cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced (those that list it, or list no cells)."""
    man = manifest()
    key = "per_layer" if trace_on else "end_to_end"
    return [m for m in man[key] if name in m.get("workloads", [name])]


def load_reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, or failing that the
    reader of the name with its last ``.<suffix>`` taken off."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        return load_reader(metric.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(run: Run, request, seconds: float, traced: bool, readers: dict):
    """The window: whole requests, one after another, from the first
    request's start to the end of the last that finished within
    ``seconds`` (at least one).  A request that would not finish by then,
    judged from the mean so far, is not started.  With ``traced`` the first
    request runs under the profiler, inside the readers' instruments, and
    one untraced request runs before the window, uncounted: its wall is the
    one the device's idle share divides by, taken before the profiler has
    slowed the host."""
    outputs = []
    if traced:
        r0 = time.perf_counter()
        request.run({})
        run.untraced_walls.append(time.perf_counter() - r0)
    t_start = time.perf_counter()
    t_end = t_start
    while True:
        now = time.perf_counter()
        walls = [r["wall"] for r in run.requests]
        if walls and (now - t_start + statistics.fmean(walls) > seconds):
            break
        record = {}
        before = counters.snapshot()
        r0 = time.perf_counter()
        if traced and not run.requests:
            with contextlib.ExitStack() as stack:
                for m in readers.values():
                    if hasattr(m, "instrument"):
                        stack.enter_context(m.instrument(run))
                out, run.trace = trace.capture(lambda: request.run(record))
            wall = run.trace["window_s"]
            # The trace's reduction is no part of the request: the window
            # stands still while it runs.
            t_start += time.perf_counter() - r0 - wall
            r1 = time.perf_counter()
        else:
            out = request.run(record)
            r1 = time.perf_counter()
            wall = r1 - r0
        if run.requests and r1 - t_start > seconds:
            break  # finished past the window: dropped
        record["wall"] = wall
        record["counters"] = counters.delta(before, counters.snapshot())
        run.requests.append(record)
        outputs.append(out)
        t_end = r1
    run.window_s = t_end - t_start
    total = {}
    for r in run.requests:
        total = counters.add(total, r["counters"])
    run.counters = total
    return outputs


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *, t0: float,
             device: str = "cuda", config=None, traffic=None, limits=None,
             metrics=None) -> dict:
    """One run; returns the result, the object of the JSON line.  ``config``,
    ``traffic``, ``limits`` and ``metrics`` default to the cell's files and
    ``BENCHMARK.json`` (the CPU tests pass their own, cut to a tiny size)."""
    if config is None:
        _, config, traffic, limits = cell_files(cell)
    if metrics is None:
        metrics = metric_names(cell, traced)
    dtype = getattr(torch, config["dtype"])
    readers = {m["name"]: load_reader(m["name"]) for m in metrics}
    run = Run(cell, config, traffic)
    on_card = torch.device(device).type == "cuda"

    inputs = requests.build_inputs(config, seed)
    request = requests.make(config, traffic, inputs, dtype, device)
    request.prepare()
    if on_card:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t0

    outputs = measure(run, request, seconds, traced, readers)
    if on_card:
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # The check: after the window, with the program's state freed.
    request.release()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, notes = request.check(outputs, torch.float64, device)
    notes["reference_s"] = time.perf_counter() - t_ref
    checks = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    if on_card:
        dev_info["power_limit"] = card_power_limit()
    result = {"correct": bool(correct),
              "attempted": sum(r["attempted"] for r in run.requests),
              "failed": sum(r["failed"] for r in run.requests),
              "metrics": values, "device": dev_info}
    if traced and run.trace is not None:
        dev_info["busy_s"] = run.trace["busy_s"]
        dev_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["notes"] = {"requests": len(run.requests), "window_s": run.window_s,
                       "setup_s": run.setup_s, **notes}
    if run.trace is not None:
        result["notes"]["trace_cost_s"] = run.trace.get("cost_s")
        result["notes"]["untraced_walls_s"] = run.untraced_walls
    result["checks"] = checks
    return result
