#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds kernel K1 (the DIA SpMM, ``csrc/dia_spmm.cu``) from the sources in
this checkout, holds it against its plain PyTorch version on the card and
times both, checks one Ros1 step at n=256 on the card against the same
step on the CPU, and then drives the port's main path at full size: LRSIF
Ros1 GDRE steps on the n=79841 Rail surrogate (3 steps with the
pair-encoded shift buffer, BiCGStab; 1 with an all-real buffer, CG),
counting K1 launches.  Exits non-zero, without the final ``"ok"`` line, if
there is no CUDA device or any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse.linalg as spla
import torch

from differentialriccatiequations_jl_tpu_torch.entry import SHIFTS, entry
from differentialriccatiequations_jl_tpu_torch.kernels import build
from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm as k1
from differentialriccatiequations_jl_tpu_torch.lowrank import lowrank, lr_with_capacity
from differentialriccatiequations_jl_tpu_torch.models.compiled import (
    CompiledConfig, _residual_norm, build_dia_shift_ops, pair_encode_shifts,
    ros1_initial_residual, ros1_step_compiled)
from differentialriccatiequations_jl_tpu_torch.ops import blocklinear
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil, shifted_dia
from differentialriccatiequations_jl_tpu_torch.ops.operators import lin_comb
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate

N_FULL = 79841
KERNEL_SOURCE = "differentialriccatiequations_jl_tpu_torch/csrc/dia_spmm.cu"
TPU_KERNEL = "differentialriccatiequations_jl_tpu/ops/dia.py:281"
# Kernel vs plain: the summation order is the same, only FMA contraction
# differs, so the error is a few ulps of the largest output entry.
REL_TOL = {"float64": 1e-12, "float32": 1e-5}
# n=256 step, card vs CPU: Krylov tolerance 10·eps amplified by the ADI.
STEP_REL_TOL = 1e-9
TIMED_CALLS = 50


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn):
    """Median device time of one call over `TIMED_CALLS` calls (CUDA events),
    and the host's enqueue time per call.  A sleep kernel queued first keeps
    the stream busy, so the events time the device and not the launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_CALLS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_CALLS)]
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(100_000_000)  # about 50 ms of device time
    t0 = time.perf_counter()
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_CALLS
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends)), host_ms


def phase_build():
    """Build K1 from the checkout's source and load it."""
    t0 = time.perf_counter()
    path = build.build("dia_spmm")
    k1._kernel(torch.float64)
    log(f"[build] K1 built and loaded in {time.perf_counter() - t0:.2f} s: {path.name}")
    for line in build.build_log("dia_spmm").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")


def phase_kernels(E, A, dev):
    """K1 against its plain version on the card, every product the step
    uses, at the Rail size; times both.  Returns (max_abs_err, timings)."""
    rng = np.random.default_rng(0)
    max_abs = 0.0
    timings = {}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).removeprefix("torch.")
        E_op, A_op = dia_pencil(E, A, dtype=dt, device=dev)
        F = shifted_dia(E_op, A_op, -1.0)  # the ADI's hot operator Aᵀ + μEᵀ
        nnz = F.nnz
        offs, offs_t = F.offsets, tuple(-o for o in F.offsets)
        N = F.N
        # The step hands K1 q = 7 (the SMW solve of A⁻¹U, m = 7 inputs),
        # 48 (r_res: the Krylov block) and 96 (the capacity of X); 32 is
        # the reference bench's width.
        for q in (6, 7, 12, 32, 48, 96):
            def arr(*shape):
                return torch.as_tensor(rng.standard_normal(shape), dtype=dt, device=dev)

            Xt, Z, X = arr(q, N), arr(q, N), arr(N, q)
            # (N, q) view with unit problem stride: the layout in which the
            # real ADI step's solution reaches E.tmm
            Xv = arr(q, N).T
            a, b = 0.37, -1.21
            cases = {
                "mmT": (lambda: F.mmT(Xt),
                        lambda: k1.dia_mm_t_plain(F.data, offs, Xt)),
                "mmT_axpby": (lambda: F.mmT_axpby(Xt, Z, a, b),
                              lambda: a * k1.dia_mm_t_plain(F.data, offs, Xt) + b * Z),
                "mm": (lambda: F.mm(X),
                       lambda: k1.dia_mm_plain(F.data, offs, X)),
                "tmm": (lambda: F.tmm(Xv),
                        lambda: k1.dia_mm_plain(F.data_t, offs_t, Xv)),
            }
            for op, (kern, plain) in cases.items():
                yk, yp = kern(), plain()
                torch.cuda.synchronize()
                abs_err = float((yk - yp).abs().max())
                rel_err = abs_err / max(float(yp.abs().max()), 1e-300)
                check(bool(torch.isfinite(yk).all()), f"K1 {op} {dname} q={q}: non-finite")
                check(rel_err <= REL_TOL[dname],
                      f"K1 {op} {dname} q={q}: rel err {rel_err:.3e} > {REL_TOL[dname]}")
                max_abs = max(max_abs, abs_err)
                k_ms, k_host = time_ms(kern)
                p_ms, p_host = time_ms(plain)
                timings[(op, dname, q)] = (k_ms, p_ms)
                log(f"[kernels] {op:9s} {dname} q={q:3d}: rel err {rel_err:.2e} "
                    f"(abs {abs_err:.2e}) | K1 {k_ms * 1e3:8.2f} us "
                    f"{nnz / (k_ms * 1e-3) / 1e9:7.2f} Gnnz/s (host {k_host * 1e3:6.1f} us/call)"
                    f" | plain {p_ms * 1e3:8.2f} us {nnz / (p_ms * 1e-3) / 1e9:7.2f} Gnnz/s"
                    f" (host {p_host * 1e3:6.1f} us/call)")
    return max_abs, timings


def phase_small_step():
    """The n=256 `entry()` step on the card (kernel path) and on the CPU
    (plain path): same ADI iteration count, same X and K."""
    outs = {}
    for dev in ("cuda", "cpu"):
        fn, args = entry(dev)
        t0 = time.perf_counter()
        X, K, iters, res = fn(*args)
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[dev] = (X.to_dense().cpu(), K.cpu(), iters, float(res), X.k)
        log(f"[n=256] {dev}: {time.perf_counter() - t0:.3f} s, ADI iters {iters}, "
            f"res {float(res):.6e}, rank {X.k}")
    (Xg, Kg, ig, _, _), (Xc, Kc, ic, _, _) = outs["cuda"], outs["cpu"]
    rel_X = float(torch.linalg.norm(Xg - Xc) / torch.linalg.norm(Xc))
    rel_K = float(torch.linalg.norm(Kg - Kc) / torch.linalg.norm(Kc))
    log(f"[n=256] card vs CPU: LDLᵀ rel {rel_X:.3e}, K rel {rel_K:.3e}")
    check(ig == ic, f"n=256: ADI iterations differ (card {ig}, CPU {ic})")
    check(rel_X <= STEP_REL_TOL and rel_K <= STEP_REL_TOL,
          f"n=256: card and CPU steps differ beyond {STEP_REL_TOL}")


def phase_full_step(E, A, B, C, dev):
    """The main path at full size: 3 pair-buffer Ros1 steps then 1
    all-real-buffer step.  Returns the K1 launches of the run."""
    dt, tau, capacity = torch.float64, 10.0, 96
    cfg = CompiledConfig(maxiters=8, compression_interval=4, r_res=48)
    abstol = 1e-8
    t0 = time.perf_counter()
    E_op, A_op = dia_pencil(E, A, dtype=dt, device=dev)
    B_d = torch.as_tensor(B, dtype=dt, device=dev)
    C_d = torch.as_tensor(C, dtype=dt, device=dev)
    L0 = spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    X0 = lr_with_capacity(lowrank(torch.as_tensor(L0, dtype=dt, device=dev),
                                  0.01 * torch.eye(C.shape[0], dtype=dt, device=dev)),
                          capacity)
    F_base = lin_comb(A_op, -1.0 / (2.0 * tau), E_op)
    cache = {}
    buffers = {"pair": pair_encode_shifts(SHIFTS),
               "real": np.asarray([-0.5, -1.0, -2.0])}
    ops = {name: build_dia_shift_ops(E_op, F_base, s, block_cache=cache)
           for name, s in buffers.items()}
    torch.cuda.synchronize()
    log(f"[n={N_FULL}] setup {time.perf_counter() - t0:.2f} s; Krylov: pair "
        f"{ops['pair'].cfg.method}, real {ops['real'].cfg.method}; "
        f"nnz {E_op.nnz}, offsets {E_op.offsets}")

    plan = ["pair"] * 3 + ["real"]
    inputs, rows = [], []
    torch.cuda.reset_peak_memory_stats()
    X = X0
    k1.launches = 0  # the main path's run starts here
    blocklinear.krylov_iterations = 0
    for name in plan:
        inputs.append(X)
        l0, s0 = k1.launches, blocklinear.krylov_iterations
        torch.cuda.synchronize()
        t = time.perf_counter()
        X, K, iters, res = ros1_step_compiled(E_op, A_op, B_d, C_d, X, tau,
                                              buffers[name], abstol, cfg, ops[name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rows.append((name, wall, iters, float(res), X, K,
                     k1.launches - l0, blocklinear.krylov_iterations - s0))
    launches = k1.launches  # the main path's run ends here
    peak = torch.cuda.max_memory_allocated() / 2**30

    for j, (name, wall, iters, res, Xn, K, nl, ns) in enumerate(rows):
        _, res0 = ros1_initial_residual(E_op, A_op, B_d, C_d, inputs[j], tau, cfg)
        start = float(_residual_norm(res0.L, res0.D))  # cols >= k are zero
        finite = all(bool(torch.isfinite(t).all()) for t in (Xn.L, Xn.D, K))
        log(f"[n={N_FULL}] step {j + 1} ({name} buffer, "
            f"{ops[name].cfg.method}): wall {wall:.3f} s, ADI iters {iters}, "
            f"res {res:.6e} (start {start:.6e}), rank {Xn.k}/{Xn.r}, "
            f"K1 launches {nl}, Krylov iterations (host syncs) {ns}")
        check(finite, f"step {j + 1}: non-finite X or K")
        check(res < start, f"step {j + 1}: residual {res:.3e} not below its "
                           f"start value {start:.3e}")
        check(nl > 0, f"step {j + 1}: K1 was not launched")
    log(f"[n={N_FULL}] peak device memory {peak:.2f} GiB; K1 launches in the "
        f"run {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    dev = torch.device("cuda")
    try:
        phase_build()
        E, A, B, C = rail_surrogate(N_FULL)
        max_abs, timings = phase_kernels(E, A, dev)
        phase_small_step()
        launches = phase_full_step(E, A, B, C, dev)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    k_ms, p_ms = timings[("mmT", "float64", 48)]
    log(json.dumps({"kernels": [{
        "name": "dia_spmm", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": max_abs,
        "ms": k_ms, "plain_ms": p_ms}]}))
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
