"""The traced window: a `torch.profiler` trace of one request, kept in
memory and reduced to a summary, and the benchmark's own ranges around the
program's kernel entry points.

Reduction (`reduce_events`): the device is busy where any kernel, copy or
memset runs (the union of their intervals); an idle gap is a stretch
between two busy stretches, labelled by what the host did around it (a
synchronising call that ended inside it, and the CPU op that launched the
work ending it).  A benchmark range (`record_function` with a name that
starts ``portbench.``) owns the device time of the kernels launched while
it was open on the same thread, matched by the launch's correlation id.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

RANGE_PREFIX = "portbench."
_SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
               "cudaMemcpy", "cudaMemcpyAsync")
TOP = 10


def _kind(ev) -> str:
    """``kernel`` (a kernel, copy or memset on the device), ``runtime`` (a
    CUDA runtime call, ``cuda*`` or ``cu*``), ``range`` (a `record_function` range, on
    the host or its span on the device: no work of its own) or ``op`` (a
    host op).  From the device type, the annotation flag and the name: the
    event's activity type is not exposed by every PyTorch release."""
    name = ev.name()
    if ev.is_user_annotation() or name.startswith(RANGE_PREFIX):
        return "range"
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        return "kernel"
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return "runtime"
    return "op"


def reduce_events(events, window_s: float) -> dict:
    """Summarise Kineto events: busy seconds, the device ops that took most
    time, idle seconds by label and each benchmark range's device seconds
    and kernel count."""
    dev, launches, ops, syncs, ranges = [], [], [], [], []
    for ev in events:
        kind = _kind(ev)
        t0 = ev.start_ns()
        t1 = t0 + ev.duration_ns()
        if kind == "kernel":
            dev.append((t0, t1, ev.name(), ev.correlation_id(), ev.linked_correlation_id()))
        elif kind == "runtime":
            name = ev.name()
            if "Launch" in name or "Memcpy" in name or "Memset" in name:
                launches.append((t0, ev.correlation_id(), ev.start_thread_id()))
            if name.startswith(_SYNC_NAMES):
                syncs.append(t1)
        elif kind == "range" and ev.device_type() != torch.autograd.DeviceType.CUDA:
            ranges.append((t0, t1, ev.name(), ev.start_thread_id()))
        elif kind == "op":
            ops.append((t0, t1, ev.name()))

    out = {"window_s": window_s, "busy_s": 0.0, "device_ops": [], "idle_gaps": [],
           "ranges": {}, "device_events": len(dev)}
    if not dev:
        return out
    dev.sort()

    # Busy: the union of the device intervals.
    merged = []
    for s, e, *_ in dev:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    out["busy_s"] = sum(e - s for s, e in merged) * 1e-9

    by_name = defaultdict(int)
    for s, e, name, *_ in dev:
        by_name[name] += e - s
    out["device_ops"] = [[n[:160], t * 1e-9] for n, t in
                         sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    # Which launch (time) produced each device event: by correlation id.
    launch_at = {c: t for t, c, _ in launches}
    ops.sort()
    op_starts = [o[0] for o in ops]
    reach = []  # reach[i]: the latest end among ops[0..i]
    for o in ops:
        reach.append(max(o[1], reach[-1]) if reach else o[1])
    syncs.sort()
    first_of = {}  # merged interval index -> the device event that opens it
    mi = 0
    for ev in dev:
        while ev[0] > merged[mi][1]:
            mi += 1
        first_of.setdefault(mi, ev)

    def launcher(ev) -> str:
        t = launch_at.get(ev[3], launch_at.get(ev[4]))
        if t is None:
            return "unknown"
        i = bisect.bisect_right(op_starts, t) - 1
        # The innermost op still open at t: walk back over ops that ended
        # before it, as long as an earlier one may still be open.
        while i >= 0 and ops[i][1] < t and reach[i] >= t:
            i -= 1
        return ops[i][2] if i >= 0 and ops[i][1] >= t else "host code outside an op"

    idle = defaultdict(int)
    for i in range(1, len(merged)):
        g0, g1 = merged[i - 1][1], merged[i][0]
        j = bisect.bisect_left(syncs, g0)
        synced = j < len(syncs) and syncs[j] <= g1
        label = ("after sync, then " if synced else "") + launcher(first_of[i])
        idle[label] += g1 - g0
    out["idle_gaps"] = [[n, t * 1e-9] for n, t in
                        sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]

    # Benchmark ranges: device time of the kernels their launches produced.
    if ranges:
        ranges.sort()
        r_starts = [r[0] for r in ranges]
        owner = {}
        for t, corr, tid in launches:
            i = bisect.bisect_right(r_starts, t) - 1
            if i >= 0 and ranges[i][1] >= t and ranges[i][3] == tid:
                owner[corr] = ranges[i][2]
        stats = defaultdict(lambda: {"device_s": 0.0, "kernels": 0})
        for s, e, name, corr, linked in dev:
            r = owner.get(corr, owner.get(linked))
            if r is not None:
                stats[r]["device_s"] += (e - s) * 1e-9
                stats[r]["kernels"] += 1
        out["ranges"] = {k: dict(v) for k, v in stats.items()}
    return out


def capture(fn):
    """Run ``fn()`` under the profiler (host and device activity) and return
    ``(fn's result, summary)``; the window is ``fn``'s host wall up to a
    device synchronize."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    t2 = time.perf_counter()
    out = reduce_events(events, window_s)
    out["cost_s"] = {"stop": t1 - t0 - window_s, "events": t2 - t1,
                     "reduce": time.perf_counter() - t2, "n_events": len(events)}
    return result, out


class Meter:
    """Bytes, operations and least times of the calls made through the
    wrapped entry points, by range name."""

    def __init__(self):
        self.calls = defaultdict(lambda: {"calls": 0, "bytes": 0, "flops": 0, "bound_s": 0.0})

    def add(self, rng: str, nbytes: int, flops: int, bound: float):
        c = self.calls[rng]
        c["calls"] += 1
        c["bytes"] += nbytes
        c["flops"] += flops
        c["bound_s"] += bound


@contextlib.contextmanager
def wrapped(module, counts: dict, rng: str, meter: Meter):
    """Replace ``module.<name>`` for each ``name: count`` by a wrapper that
    opens the range ``rng`` around the call and adds ``count(*args, **kw)``
    (bytes, operations, bound seconds) to ``meter``; restored on exit.  A
    name already wrapped for the same range is left as it is."""
    saved = {}
    for name, count in counts.items():
        fn = getattr(module, name)
        if getattr(fn, "_portbench_range", None) == rng:
            continue

        def wrapper(*args, _fn=fn, _count=count, **kw):
            nbytes, flops, bound = _count(*args, **kw)
            meter.add(rng, nbytes, flops, bound)
            with torch.profiler.record_function(rng):
                return _fn(*args, **kw)

        wrapper._portbench_range = rng
        saved[name] = fn
        setattr(module, name, wrapper)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
