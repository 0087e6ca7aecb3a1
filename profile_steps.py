#!/usr/bin/env python3
"""Where the time of one step goes, on one GPU.

    python3 profile_steps.py [--dense-only] [OUT_DIR]

Builds K1 and K2, then runs one step of each full-size path of
`chip_smoke.py` (the n=79841 Rail surrogate, f64) three times from the same
state: first (library set-up included), under `torch.profiler` (CPU and
CUDA activities), and once more unprofiled.

* ``dia``: the LRSIF Ros1 step on the DIA pencil with the pair-encoded
  shift buffer (BiCGStab), as in `chip_smoke.py` phase 3;
* ``bell``: the LRSIF Ros2 step on the block-ELL pencil with 16 real
  Penzl shifts (CG), as in `chip_smoke.py` phase 5;
* ``newton``: Newton step 1 of `solve_gare_newton_compiled` (the step
  after the first closed-loop shift build: its rebuild gate, inner ADI and
  the next step's residual), as in `chip_smoke.py` phase 7.  A Newton step
  cannot be rerun from its state, so the solve runs twice, cut after step 2:
  once unprofiled, once with the profiler on for the step;
* ``host``: the host ADI through the public API, `init(GALEProblem, ADI(
  shifts=Cyclic(Heuristic(20, 30, 30)), maxiters=HOST_ITERS))` and
  ``solve()`` on the DIA pencil, as in `chip_smoke.py` phase 10 cut to its
  shift set-up and `HOST_ITERS` ADI iterations, with `utils.timers` on:
  its sections (``shifts.arnoldi``, ``adi.shifted_solve``, ...) are
  `torch.profiler` ranges, listed with their host times after the kernels;
* ``dense``: one dense Ros2 step (`rosenbrock_dense._ros2_step`) on the
  n=5177 dense Rail surrogate from ``X0``, as in `chip_smoke.py` phase 13,
  with the device time split by kernel class (`DENSE_CLASSES`: the LU
  factorizations, the triangular solves, the GEMMs, the rest).

Prints, per path, the step's wall clock with and without the profiler, the
summed device time of all kernels and copies and its share of the profiled
wall, the kernel launches and host syncs, K1's share of the device time,
and the largest device-time kernels; with ``OUT_DIR``, writes the full
kernel tables to ``OUT_DIR/profile_<path>.txt``.  ``--dense-only`` builds
the kernels and profiles the ``dense`` path alone.
Exits non-zero without a CUDA device.  Imports nothing of JAX.
"""

from __future__ import annotations

import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import warnings

import numpy as np
import scipy.sparse.linalg as spla
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from differentialriccatiequations_jl_tpu_torch.lowrank import lowrank, lr_compress, lr_with_capacity
from differentialriccatiequations_jl_tpu_torch.models import compiled
from differentialriccatiequations_jl_tpu_torch.models.compiled import (
    _ROS2_GAMMA, _abstol_default, build_dia_shift_ops, build_step_shift_solvers,
    pair_encode_shifts, ros1_step_compiled, ros2_step_compiled, solve_gare_newton_compiled)
from differentialriccatiequations_jl_tpu_torch.models.rosenbrock_dense import _ros2_step
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil
from differentialriccatiequations_jl_tpu_torch.ops.operators import lin_comb, scale_op
from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_pencil
from differentialriccatiequations_jl_tpu_torch.utils import timers
from differentialriccatiequations_jl_tpu_torch.utils.callbacks import Observer
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate

LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
K1_NAMES = re.compile(r"\bdia_(rows|flat)_kernel<")  # csrc/dia_spmm.cu


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def report(name: str, step, out: Path | None, ranges: bool = False):
    _, first = timed(step)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_prof = timed(step)
    _, wall = timed(step)
    summarize(name, prof, f"first {first:.3f} s, profiled {wall_prof:.3f} s, "
              f"unprofiled {wall:.3f} s", wall_prof, out, ranges)
    return prof


RANGES = re.compile(r"^(adi|shifts|smw|newton|gdre)\.")  # utils/timers sections


def summarize(name: str, prof, walls: str, wall_prof: float, out: Path | None,
              ranges: bool = False) -> None:
    """Device time by kernel, launches and host syncs of a finished profile."""
    by_kernel = defaultdict(lambda: [0.0, 0])
    launches = syncs = 0
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) or RANGES.match(e.name):
            continue  # a `record_function` range mirrored on the device, no kernel
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name][0] += e.time_range.elapsed_us()
            by_kernel[e.name][1] += 1
        elif e.name in LAUNCH:
            launches += 1
        elif e.name in SYNC:
            syncs += 1
    device_ms = sum(t for t, _ in by_kernel.values()) / 1e3
    k1_ms = sum(t for k, (t, _) in by_kernel.items() if K1_NAMES.search(k)) / 1e3
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    cs.log(f"[{name}] wall {walls}; device time {device_ms:.1f} ms ({100 * device_ms / 1e3 / wall_prof:.1f} % "
           f"of the profiled wall); kernel launches {launches}; host syncs {syncs}; K1 {k1_ms:.1f} ms "
           f"({100 * k1_ms / max(device_ms, 1e-9):.1f} % of the device time)")
    lines = [f"{t / 1e3:10.3f} ms {100 * t / 1e3 / device_ms:5.1f} % {c:7d} calls  {k}"
             for k, (t, c) in rows]
    for line in lines[:12]:
        cs.log(f"[{name}]   {line}")
    if ranges:  # the timer sections, as profiler ranges: host time and calls
        table = [f"{a.cpu_time_total / 1e3:10.3f} ms host {a.count:7d} calls  {a.key}"
                 for a in prof.key_averages()
                 if RANGES.match(a.key) and a.device_type == torch.autograd.DeviceType.CPU]
        for line in table:
            cs.log(f"[{name}] range {line}")
        lines += ["", "profiler ranges (utils/timers sections):"] + table
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"profile_{name}.txt").write_text("\n".join(lines) + "\n")


class StepWindow(Observer):
    """Times (and, given a profiler, profiles) Newton step ``k``: from its
    first ``gare_step`` event to step ``k + 1``'s first."""

    def __init__(self, k: int, prof=None):
        self.k, self.prof, self.t = k, prof, {}

    def observe_gare_step(self, iter, X, residual, residual_norm):
        if iter in (self.k, self.k + 1) and iter not in self.t:
            torch.cuda.synchronize()
            self.t[iter] = time.perf_counter()
            if self.prof is not None:
                (self.prof.start if iter == self.k else self.prof.stop)()

    @property
    def wall(self) -> float:
        return self.t[self.k + 1] - self.t[self.k]


def report_newton(E, A, B, C, dev, out: Path | None) -> None:
    """Newton step 1 at full size, unprofiled and then profiled."""
    prob = cs.newton_problem(E, A, B, C, dev)
    walls = []
    for prof in (None, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        window = StepWindow(1, prof)
        rebuilds = compiled.shift_rebuild_seconds
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the depth cut warns
            _, info = solve_gare_newton_compiled(
                prob, shifts=cs.NEWTON_SHIFTS, cfg=cs.SWEEP_CFG, capacity=cs.CAPACITY,
                maxiters=2, reltol=cs.NEWTON_RELTOL, observer=window)
        walls.append(window.wall)
    cs.log(f"[newton] step 1: {info['adi_iters'][1]} ADI iterations, shift builds in the solve "
           f"{info['shift_rebuilds']} ({compiled.shift_rebuild_seconds - rebuilds:.3f} s on the host)")
    summarize("newton", prof, f"unprofiled {walls[0]:.3f} s, profiled {walls[1]:.3f} s",
              walls[1], out)


HOST_ITERS = 6


def report_host(E, A, B, C, dev, out: Path | None) -> None:
    """The host-API GALE, cut to `HOST_ITERS` ADI iterations: first,
    profiled, unprofiled; then the timer sections as profiler ranges."""
    ops = dia_pencil(E, A, dtype=torch.float64, device=dev)
    prob = cs.host_problem("gale", E, A, B, C, ops)
    alg = cs.ADI(shifts=cs.HOST_SHIFTS, maxiters=HOST_ITERS, warn_convergence=False)
    timers.reset()
    timers.enable(True)
    try:
        report("host", lambda: cs.init(prob, alg).solve(), out, ranges=True)
        for name, (sec, calls) in sorted(timers.report().items()):
            cs.log(f"[host] timer {name}: {sec:.3f} s in {calls} calls (three solves)")
    finally:
        timers.enable(False)


# Kernel classes of the dense step, matched in order on the device kernel's
# name (cuSOLVER, MAGMA and cuBLAS kernels; an LU's panel updates run as
# GEMMs and triangular solves of their own and are counted there).
DENSE_CLASSES = (("triangular solves", re.compile(r"trsm|trsv|getrs", re.I)),
                 ("GEMMs", re.compile(r"gemm|xmma|cutlass", re.I)),
                 ("LU factorizations", re.compile(r"getrf|getf2|laswp|iamax|swap|pivot|magma", re.I)))


def report_dense(out: Path | None) -> None:
    """One dense Ros2 step at n=5177: `report` (the card's busy share of
    the profiled wall among it), then the device time by kernel class."""
    prob, _ = cs.dense_gdre(cs.N_DENSE, "cuda")
    Ed, Ad = prob.E.to_dense(), prob.A.to_dense()
    CtC = prob.C.T @ prob.C
    K = (prob.B.T @ prob.X0) @ Ed
    tau = -cs.ROS1_DT
    prof = report("dense", lambda: _ros2_step(Ed, Ad, prob.B, CtC, prob.X0, K, tau), out)
    by_class = defaultdict(float)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        name = next((c for c, rx in DENSE_CLASSES if rx.search(e.name)), "other")
        by_class[name] += e.time_range.elapsed_us() / 1e3
    total = sum(by_class.values())
    for name, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        cs.log(f"[dense] {name}: {ms:.1f} ms ({100 * ms / total:.1f} % of the device time)")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_steps: no CUDA device", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if a != "--dense-only"]
    out = Path(args[0]) if args else None
    cs.log(f"[card] {cs.card_line()}")
    cs.phase_build()
    if "--dense-only" in sys.argv:
        report_dense(out)
        return 0
    dev, dt, tau = torch.device("cuda"), torch.float64, cs.TAU
    E, A, B, C = rail_surrogate(cs.N_FULL)
    B_d = torch.as_tensor(B, dtype=dt, device=dev)
    C_d = torch.as_tensor(C, dtype=dt, device=dev)

    # The DIA Ros1 step (chip_smoke.py phase 3, first step).
    E_op, A_op = dia_pencil(E, A, dtype=dt, device=dev)
    pair = pair_encode_shifts(cs.SHIFTS)
    ops = build_dia_shift_ops(E_op, lin_comb(A_op, -1.0 / (2.0 * tau), E_op), pair)
    L0 = spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    X0 = lr_with_capacity(lowrank(torch.as_tensor(L0, dtype=dt, device=dev),
                                  0.01 * torch.eye(C.shape[0], dtype=dt, device=dev)),
                          cs.CAPACITY)
    cfg1 = cs.CompiledConfig(maxiters=8, compression_interval=4, r_res=48)
    report("dia", lambda: ros1_step_compiled(E_op, A_op, B_d, C_d, X0, tau, pair, 1e-8,
                                             cfg1, ops), out)
    del E_op, A_op, ops

    # The block-ELL Ros2 step (chip_smoke.py phase 5, first step).
    E_b = bell_pencil(E, A, bs=cs.BS, dtype=dt, device=dev)
    prob, shifts, _ = cs.ros2_problem(E, A, B, C, E_b, dev, 1, cs.CAPACITY)
    F_core = lin_comb(scale_op(E_b[1], _ROS2_GAMMA * tau), -0.5, E_b[0])
    lus = build_step_shift_solvers(E_b[0], F_core, np.asarray(shifts))
    del F_core
    X = lr_with_capacity(lr_compress(prob.X0, r_out=prob.X0.r), cs.CAPACITY)
    abstol = _abstol_default(prob)
    report("bell", lambda: ros2_step_compiled(E_b[0], E_b[1], prob.B, prob.C, X, tau, shifts,
                                              abstol, cs.SWEEP_CFG, lus), out)
    del E_b, prob, lus, X

    # Newton step 1 (chip_smoke.py phase 7).
    report_newton(E, A, B, C, dev, out)

    # The host-API GALE (chip_smoke.py phase 10, cut).
    report_host(E, A, B, C, dev, out)

    # One dense Ros2 step (chip_smoke.py phase 13).
    report_dense(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
