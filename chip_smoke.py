#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds kernels K1 (the DIA SpMM, ``csrc/dia_spmm.cu``) and K2 (the
block-ELL SpMM, ``csrc/bell_spmm.cu``) from the sources in this checkout,
both compilers started together, and then:

1. holds each kernel against its plain PyTorch version on the card, at the
   n=79841 Rail surrogate and the widths the steps use, and times the
   kernel, the plain version and one ``torch.sparse`` call (the yardstick,
   which the port never calls); K1 also on operands rotated through more
   than the L2, so that its share of the bytes bound is a real one;
2. checks one Ros1 step at n=256 on the card against the same step on the
   CPU;
3. drives the DIA path at full size: LRSIF Ros1 GDRE steps on the n=79841
   Rail surrogate (3 steps with the pair-encoded shift buffer, BiCGStab; 1
   with an all-real buffer, CG), counting K1 launches;
4. checks the block-ELL Ros2 sweep at n=1357 on the card against the CPU;
5. drives the block-ELL path at full size: `solve_gdre_ros2_compiled` on
   the n=79841 Rail surrogate (bs=128, f64, 16 Penzl shifts), counting K2
   launches;
6. checks the compiled Kleinman–Newton GARE solver at n=1357 on the card
   against the CPU (the north-star configuration cut to 20 Newton steps),
   both with their closed-loop rebuilds on the card route;
7. drives the Newton path at full size: `solve_gare_newton_compiled` on the
   n=79841 Rail surrogate's DIA pencil (the reference bench's north-star
   GARE configuration, f64, reltol 1e-10) to its end, counting K1 launches,
   and holds its last residual against an independent evaluation;
8. runs the public ``solve`` on the card and on the CPU, small: the GALE by
   the host ADI with Cyclic(Heuristic) shifts (n=1357), the first step of
   the low-rank GDRE sweep by Ros1 with the default Projection shifts and
   the GARE by Newton (both n=371), all on DIA pencils: equal ADI and
   Newton counts, Krylov counts within 2 %, equal shift sequences, LDLᵀ and
   K within tolerance;
9. holds complex shifted products (μ = −1 ± 0.5i, scaled to the pencil) on
   DIA and block-ELL pencils at n=1357 against their plain versions, and one
   ADI double step on the card against the CPU, counting K1 and K2 launches;
10. drives the public ``solve`` at full size on the DIA pencil: the GALE by
    the host ADI with Cyclic(Heuristic(20, 30, 30)), the low-rank GDRE by
    Ros1 (5 steps, Projection shifts on the closed loop) and the GARE by
    Newton with Cyclic(Heuristic(20, 30, 30)), counting K1 launches;
11. drives the same GALE on the block-ELL pencil, counting K2 launches;
12. runs the dense path on the card and on the CPU, small: the GALE by the
    sign function and by the SciPy oracle (n=371), by Kronecker (n=40), the
    dense GDRE by Ros1 to Ros4 (n=371, 5 steps): X and K within 1e-9;
13. drives the dense path at full size on the n=5177 Rail surrogate: the
    GALE by the sign function (residual at most 1e-10) and the dense GDRE by
    Ros1 to Ros4 (5 steps each), printing each run's wall, peak memory,
    split between the sign iterations and the replays, share of the f64
    operations bound and ‖M_final + I‖_F/√n; then holds the low-rank Ros1
    and Ros2 on the DIA pencil (through K1) and the compiled Ros2 sweep on
    dense cores against the dense K within ‖K‖·n·eps·100 (rail.jl:52-70);
14. runs GMRES on the card and on the CPU, small (`Krylov(method="gmres")`
    on one shifted DIA operator and the README's GALE under FGMRES with an
    ADI preconditioner at n=1357, the compiled Newton+FGMRES at n=371), then
    at full size on the DIA pencil: the GALE under FGMRES through the public
    ``solve`` (its restart loop included) and the compiled Newton+FGMRES
    (cut to `FGMRES_FULL_MAXITERS` steps, and at n=1357 to
    `FGMRES_SMALL_MAXITERS`);
15. runs the mixed-precision core (f32 Krylov cores with f64 iterative
    refinement) on the card and on the CPU at n=1357 (refined solves on a
    real and a pair DIA slot and on block-ELL, the compiled GALE), then at
    full size: the compiled GALE with the f32 core and with the f64 core,
    the compiled Newton with f32 inner solves (to its end, at most
    `MIXED_NEWTON_MAXITERS` steps) and one refined solve on the block-ELL
    pencil against the f64 solve, counting K1 and K2 launches by dtype;
16. runs parareal (`solve_gdre_parareal`, `bench.py`'s parareal
    configuration) on the card and on the CPU at n=1357, each held to its
    serial Ros1 sweep (max_iters = slabs: classical exactness), card vs CPU,
    and once more over a world-size-1 NCCL mesh (`parallel.make_mesh`);
    then at full size on the DIA pencil (8 slabs of 4 steps, 2 parareal
    iterations) beside the serial 32-step sweep, counting K1 launches; then
    the row-sharded DIA and block-ELL products at n=79841 in 4 emulated
    shards (each shard's local product on the halo-extended operand through
    K1 or K2) against the unsharded products and the plain versions;
17. runs the row-sharded compiled steps (ROADMAP item 10b): at n=79841 on
    the card, phase 3's 4 Ros1 steps and one Newton step from its X0, once
    without a group and once on row shards (128-row blocks) over a
    world-size-1 NCCL group, equal ADI iterations, Krylov iterations within
    2 %, LDLᵀ and K within 1e-10, printing each wall, K1 launches,
    collectives per step and peak memory (one card has no neighbour: the
    halo exchanges send nothing); then the JAX package's sharded-sweep test
    configuration at n=1357 over 4 gloo ranks on the host's CPU against one
    process;
18. runs the block-ELL shards, Ros2 on shards, the f32 refined core and
    GMRES over a mesh (ROADMAP item 10c), each without a group and then on
    row shards over a world-size-1 NCCL group, held to each other (equal
    ADI iterations, Krylov iterations within 2 %, K, LDLᵀ and solutions
    within 1e-10): 18a phase 5's block-ELL Ros2 sweep at n=79841 on
    block-ELL shards (equal K2 launches; walls, collectives per step and
    peaks printed), 18b two Ros2 steps on DIA shards from phase 3's inputs,
    18c phase 15's compiled GALE with the f32 core on DIA shards and its
    refined block-ELL solve on block-ELL shards (launches by dtype), 18d a
    GMRES solve of Aᵀ − Eᵀ on DIA shards; then 18e, at n=1357 over 4 gloo
    ranks on the host's CPU against one process, the block-ELL Ros2 sweep
    (phase 4's configuration), a `gram` compression and the GMRES solve;
19. runs the uncached compiled route, complex banded cores and the full
    compiled Newton on row shards (ROADMAP items 11 and 10d): 19a phase 3's
    first Ros1 step at n=79841 with the 1-D complex buffer ``[−0.5,
    −1 ± 0.5i, −2]``, once without shift solvers (a solver prepared per ADI
    iteration) and once on complex banded cores, each held to the
    pair-encoded step (equal ADI iterations, K and LDLᵀ within 1e-9), K1
    launches counted by route; 19b the uncached Ros1 step on the block-ELL
    pencil (real buffer) against its cached step, through K2; 19c the
    north-star Newton at capacity 192 on DIA row shards over a world-size-1
    NCCL group against the same solve without a group, both rebuilding
    their shifts on the host (equal steps,
    θ-stages, rebuilds and shift sets, K within 1e-10, each last residual
    confirmed independently), walls, collectives per step and peaks
    printed; 19d that Newton at n=256 over 2 gloo ranks on the host's CPU
    against one process;
20. runs the fused CG iteration (`kernels.cg_fused`): 20a each of its four
    kernels against its plain version at n=79841, q = 7 and 48, f64 and f32,
    on DIA's lane-major state (block-Jacobi and Jacobi) and block-ELL's
    column-major one, timed at q = 48 f64 beside the plain versions and
    the bound; 20b one CG solve at q = 48 and q = 7 through the fused
    iteration and the present loop, each a wall per CG iteration and its
    launches per CG iteration (the profiler's kernels and copies, and the
    launch counters); 20c one DIA Ros1 step (all-real buffer, CG) and one
    block-ELL Ros2 step through both: equal ADI and Krylov iterations, K
    and LDLᵀ within 1e-12; 20d phase 15's compiled GALE with the f32 core
    and with the f64 core through both: equal ADI iterations, Krylov
    iterations within one, LDLᵀ within 1e-9, each residual confirmed
    independently.  The kernels line's ``cg_fused`` entry gives the fused
    kernels' launches on each main path (phases 3, 5, 7, 10, 11 and 15);
21. runs the Newton's closed-loop Penzl rebuild on the card
    (`heuristic_shifts_card`) at n=79841: the block-tridiagonal Cholesky
    factors of ``E`` and ``−A`` against SuperLU (1e-12 relative), their
    bytes and build walls, one application's device time by CUDA events
    behind a sleep that covers the enqueue of every timed call (beside
    `time_ms`'s reading and the enqueue time, and for ``B``'s columns),
    then a cold 30 + 30-step rebuild and a
    warm-started 15 + 15-step one on a moved feedback through both routes:
    walls (the card's twice on the same input), the peak memory of the card
    rebuild, and equal Penzl shift sets (`SHIFT_SET_TOL` after sorting).

Phases 10, 11, 14 and 15 hold each solver's residual against an
independent evaluation (`residual`).  Every full-size path (phases 3, 5, 7,
10, 11, 13, 14, 15, 16, 17, 18 and 19) records the products it hands K1 and K2
(`ProductLog`: product, dtype, width, operand strides); after the run each
kernel is held against its plain version at every one of them.

    python3 chip_smoke.py --newton-only [--newton-capacity 192]

builds the kernels and runs phase 7 alone (at another capacity of ``X``);
``--host-only`` builds them and runs phases 8 to 11, ``--dense-only``
phases 12 and 13, ``--gmres-only`` phase 14 and ``--mixed-only`` phase 15
(both flags: both phases), ``--parareal-only`` phase 16, ``--sharded-only``
phases 17 and 18, ``--uncached-only`` phase 19, ``--krylov-only`` phase 20,
``--shifts-only`` phase 21.

Exits non-zero, without the final ``"ok"`` line, if there is no CUDA
device or any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
import torch.distributed as dist

from differentialriccatiequations_jl_tpu_torch import (
    ADI, GMRES, BartelsStewart, GALEProblem, Krylov, Kronecker, Newton, Ros1, Ros2, Ros3, Ros4,
    Shifts, init, residual, solve)
from differentialriccatiequations_jl_tpu_torch.entry import SHIFTS, entry
from differentialriccatiequations_jl_tpu_torch.kernels import bell_spmm as k2
from differentialriccatiequations_jl_tpu_torch.kernels import build, cg_fused, complex_route
from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm as k1
from differentialriccatiequations_jl_tpu_torch.lowrank import (
    LowRank, _mask_cols, lowrank, lr_add, lr_compress, lr_norm, lr_scale, lr_with_capacity,
    lr_zero)
from differentialriccatiequations_jl_tpu_torch.models import compiled
from differentialriccatiequations_jl_tpu_torch.models import lyapunov_dense
from differentialriccatiequations_jl_tpu_torch.models.compiled import (
    _ROS2_GAMMA, PREC_BS, CappedADI, CompiledConfig, PerStepHeuristic, _newton_step_compiled,
    _residual_norm,
    build_dia_shift_ops, build_sparse_shift_ops, default_dia_krylov, pair_encode_shifts,
    ros1_initial_residual,
    ros1_step_compiled, ros2_step_compiled, solve_gare_newton_compiled,
    solve_gdre_ros1_compiled, solve_gdre_ros2_compiled)
from differentialriccatiequations_jl_tpu_torch.models.parareal import (
    Parareal, solve_gdre_parareal)
from differentialriccatiequations_jl_tpu_torch.models.problems import GAREProblem, GDREProblem
from differentialriccatiequations_jl_tpu_torch.models.residuals import (
    residual_gale_lowrank, residual_gare_lowrank)
from differentialriccatiequations_jl_tpu_torch.models.rosenbrock_lowrank import _ros2_rhs1, feedback_K
from differentialriccatiequations_jl_tpu_torch.models import shifts as shift_mod
from differentialriccatiequations_jl_tpu_torch.models.shifts import heuristic_shifts_host
from differentialriccatiequations_jl_tpu_torch.ops import blocklinear
from differentialriccatiequations_jl_tpu_torch.ops.shifted import shifted_operator
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil, shifted_dia
from differentialriccatiequations_jl_tpu_torch.ops.dia_cholesky import dia_cholesky
from differentialriccatiequations_jl_tpu_torch.ops.operators import (
    DenseOp, lin_comb, op_astype, scale_op)
from differentialriccatiequations_jl_tpu_torch.ops.sparse import (
    bell_from_scipy, bell_pencil, shifted_bell)
from differentialriccatiequations_jl_tpu_torch.parallel import dryrun
from differentialriccatiequations_jl_tpu_torch.parallel import mesh as mesh_mod
from differentialriccatiequations_jl_tpu_torch.parallel import sharded_ops
from differentialriccatiequations_jl_tpu_torch.parallel.dryrun import free_port
from differentialriccatiequations_jl_tpu_torch.parallel.mesh import (
    GROUP_TIMEOUT, make_mesh, shard_lowrank, shard_operator, shard_tall, unshard_tall)
from differentialriccatiequations_jl_tpu_torch.utils import timers
from differentialriccatiequations_jl_tpu_torch.utils.callbacks import Observer
from differentialriccatiequations_jl_tpu_torch.utils.testmat import (
    rail_surrogate, rail_surrogate_dense)

CARD = "cuda"
N_FULL = 79841
N_SMALL = 1357
BS = 128
KERNELS = {
    "dia_spmm": ("differentialriccatiequations_jl_tpu_torch/csrc/dia_spmm.cu",
                 "differentialriccatiequations_jl_tpu/ops/dia.py:281"),
    "bell_spmm": ("differentialriccatiequations_jl_tpu_torch/csrc/bell_spmm.cu",
                  "differentialriccatiequations_jl_tpu/ops/sparse.py:164"),
    "cg_fused": ("differentialriccatiequations_jl_tpu_torch/csrc/cg_fused.cu", None),
}
# Kernel vs plain: K1 sums in the plain version's order, only FMA
# contraction differs.  K2 in f64 sums over slots, then over the inner
# dimension in 16-wide DMMA steps whose inner order is the tensor core's; in
# f32 over slots, then block columns, in order; the plain einsum in another
# order.  Either way a few ulps of the largest output entry.
REL_TOL = {"float64": 1e-12, "float32": 1e-5}
# Steps and sweeps, card vs CPU: Krylov tolerance 10·eps amplified by the ADI.
STEP_REL_TOL = 1e-9
TIMED_CALLS = 50
# Operand sets that K1's cold timing rotates through hold at least three
# times the H100's 50 MB L2, so no call finds its operands there.
L2_BYTES = 50e6
# The card's peaks for the bound (NVIDIA H100 SXM data sheet, at 700 W):
# 3.35 TB/s of HBM; 67 TFLOP/s for f64 (tensor cores) and for f32.
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float64: 67e12, torch.float32: 67e12}
# The full-size block-ELL sweep: the reference bench's north-star Ros2
# configuration (tau 10, 16 Penzl shifts, capacity 96, r_res 48, 5 steps).
TAU = 10.0
FULL_STEPS = 5
SMALL_STEPS = 3
SWEEP_CFG = CompiledConfig(maxiters=60, compression_interval=10, r_res=48)
CAPACITY = 96
# The n=1357 card-vs-CPU check runs at a capacity that holds every column
# the stage ADIs add.  At 96 the stage iterates overflow and `lr_add` drops
# columns (the JAX package does the same); how many depends on ranks that
# rounding decides, so the two devices drift apart by 1e-6.
SMALL_CAPACITY = 160
# The Newton phases: the reference bench's north-star GARE configuration
# (G = lowrank(1000·B), Q = lowrank(Cᵀ), closed-loop Penzl shifts
# PerStepHeuristic(20, 30, 30), the ADI configuration of the sweep above,
# capacity 96, 60 Newton steps, reltol 1e-10).  The n=1357 card-vs-CPU
# check cuts the depth to 20 Newton steps: it needs equal trajectories, not
# convergence.
NEWTON_SHIFTS = PerStepHeuristic(20, 30, 30)
NEWTON_RELTOL = 1e-10
NEWTON_MAXITERS = 60
SMALL_NEWTON_MAXITERS = 20
# Card vs CPU, Newton: residuals and θs within 1e-8 relative (or within
# the residual's rounding floor n·eps·‖Q‖), X and K within 1e-8.
NEWTON_REL_TOL = 1e-8
# The solver's last residual against an independent evaluation: 1e-6
# relative, or the rounding floor n·eps (relative to ‖Q‖).
RESIDUAL_AGREE_TOL = 1e-6
# The host API (phases 8-11).  The GALE of the README, the reference's
# low-rank GDRE sweep (X0 = lowrank(E⁻¹Cᵀ, 0.01·I), tspan (4500, 4400),
# dt = -20: 5 Ros1 steps) and the reference's rail.jl Newton (G = lowrank(B),
# Q = lowrank(Cᵀ), inner ADI ignoring the initial guess, reltol 1e-10).
N_TINY = 371
HOST_SHIFTS = Shifts.Cyclic(Shifts.Heuristic(20, 30, 30))
SMALL_HOST_SHIFTS = Shifts.Cyclic(Shifts.Heuristic(10, 20, 20))
ROS1_DT = -20.0
ROS1_TSPAN = (4500.0, 4400.0)
# Phase 8 holds the Ros1 sweep's first step, card vs CPU: from the second
# step on, a step's right-hand side and warm start are built from the last
# step's compressed X, whose trailing digits follow each device's rounding;
# the Projection shifts, Ritz values of the pencil projected onto that
# factor, then move by far more than 1e-10 (a near-double Ritz value moves
# with the square root of a perturbation), and the ADI, stopping at n·eps,
# may take one iteration more or less.  The first step starts from the same
# X0 on both devices.
SMALL_ROS1_TSPAN = (4500.0, 4480.0)
HOST_NEWTON_MAXITERS = 10
# Card vs CPU, host API: equal ADI iterations in every ADI solve and equal
# Newton steps; LDLᵀ and K within 1e-9 relative (1e-8 for Newton), as the
# compiled paths above.  Shifts within 1e-10 relative where they were drawn
# while the ADI's relative residual was above 1e-6; below that, the
# residual factor carries its own rounding error (about eps·‖W₀‖/‖W‖
# relative) into the projected pencil, and only the count and the
# real/complex pattern of the shifts are held equal.
SHIFT_REL_TOL = 1e-10
SHIFT_GATE = 1e-6
# Krylov iterations, card vs CPU, within 2 % in all: BiCGStab's erratic
# residual crosses the 1e-12 stopping bound an iteration earlier or later
# when its sums are taken in another order (measured at n = 1357: 2,725 on
# the card, 2,699 on the CPU, 0.96 %, with equal shifts, ADI iterations and
# LDLᵀ within 2.4e-13).
KRYLOV_REL_TOL = 0.02
# The host ADI's residual is that of its recursively updated factor W; the
# independent evaluation is that of the returned X, whose compressions cut
# eigenvalues below 100·eps·max|λ| every 10 iterations.  It is confirmed to
# 1e-6 relative, or to 100·n·eps relative to the right-hand side (on the CPU
# at n = 371, 1357 and 5177 the two differ by at most 26·n·eps).
HOST_FLOOR_FACTOR = 100.0
# Complex shifted products, kernel vs plain: f64 sums in another order.
COMPLEX_REL_TOL = 1e-13
# The dense path (phases 12-13): the GALE with right-hand side CᵀC by the
# sign-function iteration (its fixed 40 steps, no early exit), and the
# reference's dense GDRE, X0 = E⁻¹Cᵀ·0.01·C E⁻ᵀ on ROS1_TSPAN with dt =
# ROS1_DT (5 steps), by Ros1 to Ros4.  n = 5177 is the reference CI
# benchmark's Rail size (benchmarks.jl:40).
N_DENSE = 5177
N_KRON = 40
DENSE_ALGS = (Ros1, Ros2, Ros3, Ros4)
DENSE_STAGES = {Ros1: 1, Ros2: 2, Ros3: 3, Ros4: 4}
# The n×n×n products with which each step builds its stage right-hand
# sides (rosenbrock_dense.py), beside its sign iteration and replays.
DENSE_STEP_GEMMS = {Ros1: 2, Ros2: 4, Ros3: 8, Ros4: 8}
SIGN_ITERS = 40
# Card vs CPU (phase 12): X and every K within 1e-9 relative (PERF.md §2).
DENSE_REL_TOL = 1e-9
# The GALE's relative residual ‖R‖_F / ‖CᵀC‖_F (tiny_random.jl:38).
GALE_RES_TOL = 1e-10
# ‖M_final + I‖_F/√n of every sign iteration: after convergence M = −I up
# to rounding (about √n·eps for O(1) entries).
SIGN_GAP_TOL = 1e-10
# Orders 2-4 against Ros4 at the last stop.  At τ = 20 they part more than
# at the JAX package's τ = 5 (its test holds 1e-4 there, and 5e-2 for
# Ros1): on the n = 371 surrogate, against a τ = 2.5 Ros4, Ros3 is 9.8e-3
# off at τ = 20 and 6.4e-5 at τ = 10, Ros2 2.2e-4 (CPU runs).
ORDER_TOL = 5e-2
# The compiled Ros2 sweep on dense cores (`ShiftLUs`): 16 Penzl shifts of
# (E, γτA − E/2) as phase 5 builds them, at the dense sweeps' τ = 20.  Its
# K against the dense Ros2's at n = 1357 on the CPU: 1.9e-6 at capacity 96
# and r_res 48 (columns dropped), 2.1e-11 at 128 and 64, 1.1e-12 at 192 and
# 64 and at 256 and 96 (the limit there is 3.0e-11).
DENSE_SWEEP_CFG = CompiledConfig(maxiters=60, compression_interval=10, r_res=96)
DENSE_SWEEP_CAPACITY = 256
# GMRES (phase 14).  Card vs CPU: `Krylov(method="gmres")` on Aᵀ − Eᵀ
# (restart 20, maxiter 3) and the README's GALE under FGMRES at n=1357; the
# compiled Newton+FGMRES at n=371 (its CPU side about 13 s).  Full size: the
# same GALE, and `bench.py`'s Newton+FGMRES family (GMRES(5), CappedADI(15,
# 64, 192), PerStepHeuristic(20, 30, 30), CompiledConfig(100, 10, 48)) at
# capacity 192 (the ADI Newton aborts at 96 at this n) and reltol 1e-8 (the
# FGMRES class of tests/test_compiled.py), cut to FGMRES_FULL_MAXITERS
# Newton steps to fit the time budget, and at n=1357 to
# FGMRES_SMALL_MAXITERS (on the CPU it converges there in 24 steps; on the
# card it stalls at FGMRES's floor, 1.8e-8 after 60 steps, 105 s).
GMRES_KRYLOV = Krylov(method="gmres", restart=20, maxiter=3, tol=1e-12, negate=True,
                      preconditioner="block_jacobi")
GALE_FGMRES = GMRES(maxiters=3, maxrestarts=1, reltol=1e-10, preconditioner=ADI(
    maxiters=10, shifts=HOST_SHIFTS, compression_interval=20, warn_convergence=False))
NEWTON_FGMRES = GMRES(maxiters=5, maxrestarts=0, ignore_initial_guess=True,
                      warn_convergence=False, preconditioner=CappedADI(15, 64, 192))
FGMRES_CFG = CompiledConfig(maxiters=100, compression_interval=10, r_res=48)
FGMRES_CAPACITY = 192
FGMRES_RELTOL = 1e-8
FGMRES_FULL_MAXITERS = 8
FGMRES_SMALL_MAXITERS = 30
# Card vs CPU: X and the Krylov solution within 1e-9; the FGMRES GALE's
# residual history within 1e-8 relative, or within √eps·‖C‖: its inner-cycle
# entries are least-squares estimates from Hessenberg entries that are
# Gram-form norms √tr((D·LᵀL)²), whose rounding floor is √eps of the norms
# that cancel (at n=1357 they sit at 2.4e-9·‖C‖ on both devices, 10 %
# apart, while the true residual after the cycle is 3.6e-13·‖C‖).  The
# compiled Newton+FGMRES: its history within 3e-4 relative (from its 12th
# step on, inner solves whose happy breakdowns and compression cuts
# rounding decides move it by up to 3.0e-5 between the port and the JAX
# package on the CPU, tests/test_torch_gmres.py) or within the FGMRES
# target 1e-8 of the first residual, and X within 3e-8: the last step
# lands below the target at a rounding-decided depth (4.3e-9 on the card,
# 2.1e-10 on the CPU at n=371, X 2.4e-9 apart, on an H100 80GB HBM3).
GMRES_REL_TOL = 1e-9
GMRES_HIST_TOL = 1e-8
FGMRES_NEWTON_HIST_TOL = 3e-4
FGMRES_X_TOL = 3e-8
# Mixed precision (phase 15): `bench.py`'s substage_gale_mixed (16 Penzl
# shifts, f32 core with 3 refinements, CompiledConfig(120, 10, 32), capacity
# 160, abstol 1e-10·‖C‖), beside the f64 core; the compiled Newton with f32
# inner solves (bench.py:855-860: CompiledConfig(150, 10, 64)) at capacity
# 192, to its end (at most MIXED_NEWTON_MAXITERS steps); one refined
# shifted solve on the block-ELL pencil.  Card vs CPU (n=1357) and refined vs f64: within 1e-9
# (both reach the f64 solution, whose CG tolerance 1e-12 the conditioning
# amplifies); the GALE's residual within 1e-4 (tests/test_torch_mixed.py).
MIXED_GALE_CFG = CompiledConfig(maxiters=120, compression_interval=10, r_res=32)
MIXED_GALE_CAPACITY = 160
MIXED_NEWTON_CFG = CompiledConfig(maxiters=150, compression_interval=10, r_res=64)
MIXED_NEWTON_MAXITERS = 60
MIXED_BELL_KRYLOV = Krylov(method="cg", negate=True, preconditioner="block_jacobi",
                           solve_dtype="float32", refine_iters=3)
MIXED_REL_TOL = 1e-9
MIXED_RES_TOL = 1e-4
# Parareal (phase 16): `bench.py`'s parareal substage (n=1357, τ = 5, 8
# slabs of 4 fine steps, 16 Penzl shifts each for the fine and the coarse
# cores, SWEEP_CFG, capacity 96, abstol n·eps·‖C‖).  16a cuts it to 4 slabs
# of 2 steps at capacity SMALL_CAPACITY with max_iters = slabs: then every
# boundary is the serial fine sweep's (classical exactness, within
# PARAREAL_EXACT_TOL as tests/test_parareal.py holds it), and the run over
# a world-size-1 NCCL mesh takes the same steps in the same order
# (PARAREAL_MESH_TOL: the all-gather copies).  16b runs it at n=79841 with
# the bench's 8 slabs of 4 steps and 2 parareal iterations.  16c splits the
# n=79841 DIA and block-ELL operators into SHARDS row shards.
PARAREAL_TAU = 5.0
PARAREAL_EXACT_TOL = 1e-8
PARAREAL_MESH_TOL = 1e-12
SHARDS = 4
# The row-sharded compiled steps (phase 17).  17a: phase 3's 4 Ros1 steps
# and one Newton step from its X0 (shifts of its real buffer, G =
# lowrank(B), Q = lowrank(Cᵀ) at capacity 16, the GARE residual as the
# entry residual) at n=79841, on row shards over a world-size-1 NCCL group,
# held to the same runs without a group: equal ADI iterations, Krylov
# iterations within KRYLOV_REL_TOL, LDLᵀ and K within SHARDED_TOL (the JAX
# package's tests/test_sharded_gdre.py:170-175).  17b: the JAX test's sweep
# (dryrun.ros1_sweep) at n=1357 over SHARDED_CPU_RANKS gloo ranks on the
# host's CPU, held to one process.
SHARDED_TOL = 1e-10
N_SHARDED_CPU = 1357
SHARDED_CPU_RANKS = 4
COLLECTIVE_CALLS = 200


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


def time_cold_ms(make_call, set_bytes: float) -> float:
    """Median device time of one call on operands that are not in the L2:
    ``make_call(r)`` returns a call on the r-th of R operand sets, with R
    sets of ``set_bytes`` holding at least 3 × the L2, used in turn."""
    sets = max(2, -(-int(3 * L2_BYTES) // int(set_bytes)))
    calls = itertools.cycle([make_call(r) for r in range(sets)])
    return time_ms(lambda: next(calls)())[0]


def share(bound: float, t: float) -> str:
    """The bound's share of a measured time; none above 100 % (a time under
    the bound can only come from a cache)."""
    return f"{100 * bound / t:.1f} %" if bound <= t else "n/a (under the bound)"


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate.  (ms, bound_by)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    """Build K1 and K2 from the checkout's sources, both compilers started
    together, and load them."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        paths = list(pool.map(build.build, KERNELS))
    k1._kernel(torch.float64)
    k2._kernel(torch.float64)
    cg_fused._kernel("pap", torch.float64)
    log(f"[build] K1, K2 and the fused CG kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(p.name for p in paths))
    for name in KERNELS:
        for line in ptxas_report(build.build_log(name)):
            log(f"[build] {name} ptxas: {line}")
    for dt in (torch.float64, torch.float32):
        for q in (7, 48, 96, 300):
            p = k2.plan(dt, q)
            log(f"[build] K2 {str(dt).removeprefix('torch.')} q={q}: {p['nt']} n8-tiles per "
                f"128-column chunk, {p['stages']}-stage ring, {p['smem_bytes']} bytes of "
                f"dynamic shared memory, 1 block of 256 threads per SM")


def ptxas_report(text: str) -> list[str]:
    """One line per compiled kernel variant from ``nvcc -Xptxas -v``:
    its (demangled) name, registers, shared memory and spills."""
    rows, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            rows.append((name, line.split(":", 1)[-1].strip() + "; " + spill))
            name = None
    names = [n for n, _ in rows]
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=30, check=True).stdout.splitlines()
        names = out if len(out) == len(names) else names
    except (OSError, subprocess.SubprocessError):
        pass
    return [f"{n.split('(')[0]}: {info}" for n, (_, info) in zip(names, rows)]


def check_close(name, got, ref, dname):
    """Max abs error of ``got`` against ``ref``; fails beyond the
    relative-to-max tolerance of the dtype."""
    torch.cuda.synchronize()
    abs_err = float((got - ref).abs().max())
    rel_err = abs_err / max(float(ref.abs().max()), 1e-300)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    check(rel_err <= REL_TOL[dname], f"{name}: rel err {rel_err:.3e} > {REL_TOL[dname]}")
    return abs_err, rel_err


class ProductLog:
    """The products that a main path hands K1 and K2, recorded at their
    launch while the path runs: for each kernel, product (K1: ``mm`` on an
    ``(N, q)`` operand, ``mmT`` on a ``(q, N)`` one, ``mmT_axpby`` with the
    epilogue; K2: ``mm``), dtype, width ``q`` and operand strides, the first
    operator storage seen.  After the run, `check` holds each kernel
    against its plain version at every one of them, on fresh operands of
    the same shape and strides: the kernels are checked at the widths the
    path feeds them.  Its launches are not the path's: the path's counts
    are read before it."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        self._launch = (k1._launch, k2._launch)
        launch1, launch2 = self._launch

        def k1_launch(data, offsets, X, axis, Z=None, alpha=1.0, beta=0.0):
            op = "mm" if axis == 0 else ("mmT" if Z is None else "mmT_axpby")
            key = ("K1", op, str(X.dtype).removeprefix("torch."), X.shape[1 - axis], X.stride())
            if X.shape[1 - axis]:
                self.seen.setdefault(key, (data, offsets, tuple(X.shape), alpha, beta))
            return launch1(data, offsets, X, axis, Z=Z, alpha=alpha, beta=beta)

        def k2_launch(cols, data, X):
            key = ("K2", "mm", str(X.dtype).removeprefix("torch."), X.shape[1], X.stride())
            if X.shape[1]:
                self.seen.setdefault(key, (cols, data, tuple(X.shape)))
            return launch2(cols, data, X)

        k1._launch, k2._launch = k1_launch, k2_launch
        return self

    def __exit__(self, *exc):
        k1._launch, k2._launch = self._launch
        return False

    def check(self, tag):
        """Each recorded product, kernel vs plain (`REL_TOL`); logs the
        widths and returns {kernel: max abs error}."""
        gen = torch.Generator(device=CARD).manual_seed(5)
        worst, widths = {}, collections.defaultdict(set)

        def operand(shape, stride, dt):
            X = torch.empty_strided(shape, stride, dtype=dt, device=CARD)
            return X.copy_(torch.randn(shape, generator=gen, dtype=dt, device=CARD))

        for key, rec in self.seen.items():
            kern, op, dname, q, stride = key
            dt = getattr(torch, dname)
            if kern == "K1":
                data, offsets, shape, alpha, beta = rec
                X = operand(shape, stride, dt)
                if op == "mm":
                    got, ref = k1.dia_mm(data, offsets, X), k1.dia_mm_plain(data, offsets, X)
                else:
                    Z = torch.randn(shape, generator=gen, dtype=dt, device=CARD)
                    Z = Z if op == "mmT_axpby" else None
                    got = k1.dia_mm_t(data, offsets, X, Z=Z, alpha=alpha, beta=beta)
                    ref = k1.dia_mm_t_plain(data, offsets, X)
                    ref = ref if Z is None else alpha * ref + beta * Z
            else:
                cols, data, shape = rec
                X = operand(shape, stride, dt)
                got, ref = k2.bell_mm(cols, data, X), k2.bell_mm_plain(cols, data, X)
            abs_err, _ = check_close(f"{tag} {kern} {op} {dname} q={q} strides {stride}",
                                     got, ref, dname)
            worst[kern] = max(worst.get(kern, 0.0), abs_err)
            widths[(kern, op, dname)].add(q)
        for (kern, op, dname), qs in sorted(widths.items()):
            log(f"{tag} {kern} {op} {dname}: kernel = plain (rel {REL_TOL[dname]:g}) at the "
                f"{len(qs)} widths the run fed it, q = {sorted(qs)}")
        self.seen.clear()
        return worst


def csr_on(M, dt, dev):
    """``torch.sparse`` CSR copy of a scipy matrix (the yardstick only)."""
    M = sp.csr_matrix(M)
    return torch.sparse_csr_tensor(
        torch.as_tensor(M.indptr, dtype=torch.int64), torch.as_tensor(M.indices, dtype=torch.int64),
        torch.as_tensor(M.data), size=M.shape, dtype=dt, device=dev)


def phase_kernels(E, A, dev):
    """K1 against its plain version on the card, every product the step
    uses, at the Rail size; times both, and at q = 48 one ``torch.sparse``
    CSR product of the same matrix.  ``mmT`` and ``mm`` are timed twice:
    back to back on the same operands (L2-warm at q <= 12, where the whole
    working set fits the L2) and rotated through operand sets larger than
    the L2 (cold), against the bound of the call.  Returns (max_abs_err,
    warm timings, cold timings, library timings, the f64 mmT q=48 bound)."""
    rng = np.random.default_rng(0)
    max_abs = 0.0
    timings, cold, library = {}, {}, {}
    F_host = (A.T - E.T).tocsr()
    for dt in (torch.float64, torch.float32):
        dname = str(dt).removeprefix("torch.")
        E_op, A_op = dia_pencil(E, A, dtype=dt, device=dev)
        F = shifted_dia(E_op, A_op, -1.0)  # the ADI's hot operator Aᵀ + μEᵀ
        F_csr = csr_on(F_host, dt, dev)
        nnz = F.nnz
        offs, offs_t = F.offsets, tuple(-o for o in F.offsets)
        N, nd, esize = F.N, len(F.offsets), F.data.element_size()
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
                nbytes = esize * (nd * N + (3 if op == "mmT_axpby" else 2) * q * N)
                b_ms, b_by = bound_ms(nbytes, 2 * nd * N * q, dt)
                warm = "L2-warm" if nbytes <= L2_BYTES else f"{share(b_ms, k_ms)} of the bound"
                line = (f"[kernels] {op:9s} {dname} q={q:3d}: rel err {rel_err:.2e} "
                        f"(abs {abs_err:.2e}) | K1 {k_ms * 1e3:8.2f} us ({warm}, "
                        f"{nnz / (k_ms * 1e-3) / 1e9:7.2f} Gnnz/s, host {k_host * 1e3:6.1f} us/call)"
                        f" | plain {p_ms * 1e3:8.2f} us (host {p_host * 1e3:6.1f} us/call)"
                        f" | bound {b_ms * 1e3:7.2f} us ({b_by})")
                if op in ("mmT", "mm"):
                    # Cold: the same call on one of several copies of the
                    # weights and the operand, in turn.
                    src = Xt if op == "mmT" else X
                    fn = k1.dia_mm_t if op == "mmT" else k1.dia_mm

                    def make_call(r, src=src, fn=fn):
                        d_r, x_r = (F.data, src) if r == 0 else (F.data.clone(), src.clone())
                        return lambda: fn(d_r, offs, x_r)

                    c_ms = time_cold_ms(make_call, nbytes)
                    cold[(op, dname, q)] = c_ms
                    line += f" | cold {c_ms * 1e3:8.2f} us ({share(b_ms, c_ms)} of the bound)"
                log(line)
                if q == 48 and op in ("mm", "mmT"):
                    lib = (lambda: F_csr @ X) if op == "mm" else (lambda: F_csr @ Xt.T)
                    ref = plain() if op == "mm" else plain().T
                    check_close(f"torch.sparse CSR {op} {dname} q={q}", lib(), ref, dname)
                    library[(op, dname, q)] = time_ms(lib)[0]
                    log(f"[kernels] {op:9s} {dname} q={q:3d}: torch.sparse CSR "
                        f"{library[(op, dname, q)] * 1e3:8.2f} us (yardstick)")
    # K1's bound at the f64 mmT q=48 call: data, operand and result once each.
    N, q, nd = F.N, 48, len(F.offsets)
    bound = bound_ms(8 * (nd * N + 2 * q * N), 2 * nd * N * q, torch.float64)
    log(f"[kernels] K1 bound, f64 mmT q=48: {bound[0] * 1e3:.2f} us ({bound[1]})")
    return max_abs, timings, cold, library, bound


def bell_library(Fs, F, dt, dev):
    """The yardstick for K2: a ``torch.sparse`` product of the matrix ``Fs``
    (scipy) that `BellOp` ``F`` holds, BSR of the same blocks if the card's
    library takes it for ``dt``, else CSR.  Returns (name, fn(X))."""
    n, N = F.n, F.nb * F.bs
    Fp = sp.bsr_matrix(sp.block_diag([Fs, sp.csr_matrix((N - n, N - n))]).tocsr(),
                       blocksize=(F.bs, F.bs))
    bsr = torch.sparse_bsr_tensor(
        torch.as_tensor(Fp.indptr, dtype=torch.int64), torch.as_tensor(Fp.indices, dtype=torch.int64),
        torch.as_tensor(Fp.data), size=Fp.shape, dtype=dt, device=dev)
    probe = torch.zeros((N, 7), dtype=dt, device=dev)
    try:
        bsr @ probe
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:  # refused for the dtype: CSR
        log(f"[K2] torch.sparse BSR x dense refused for {dt}: {str(e).splitlines()[0]}")
        csr = csr_on(Fs, dt, dev)
        return "CSR", lambda X: csr @ X
    return "BSR", lambda X: (bsr @ torch.nn.functional.pad(X, (0, 0, 0, N - n)))[:n]


def phase_k2(E_b, E, A, dev):
    """K2 against its plain version on the card at the Rail size, the
    shifted operator Aᵀ − Eᵀ, f64 and f32, ``mm`` and ``tmm`` (on the
    unit-stride view the step passes) at q = 7 (the SMW solve of A⁻¹U),
    48 (r_res: the Krylov block) and 96 (the capacity of X).  Times the
    kernel, the plain version and the ``torch.sparse`` yardstick.
    Returns (max_abs_err, timings, library timings, f64 mm q=48 bound)."""
    rng = np.random.default_rng(1)
    max_abs = 0.0
    timings, library = {}, {}
    E64, A64 = E_b
    F64 = shifted_bell(E64, A64, -1.0)
    F_host = (A.T - E.T).tocsr()
    for dt in (torch.float64, torch.float32):
        dname = str(dt).removeprefix("torch.")
        F = F64 if dt == torch.float64 else op_astype(F64, dt)
        n = F.n
        lib_name, lib = bell_library(F_host, F, dt, dev)
        for q in (7, 48, 96):
            def arr(*shape):
                return torch.as_tensor(rng.standard_normal(shape), dtype=dt, device=dev)

            X, Xv = arr(n, q), arr(q, n).T
            cases = {
                "mm": (lambda: F.mm(X), lambda: k2.bell_mm_plain(F.cols, F.data, X)),
                "tmm": (lambda: F.tmm(Xv), lambda: k2.bell_mm_plain(F.cols_t, F.data_t, Xv)),
            }
            for op, (kern, plain) in cases.items():
                abs_err, rel_err = check_close(f"K2 {op} {dname} q={q}", kern(), plain(), dname)
                max_abs = max(max_abs, abs_err)
                k_ms, k_host = time_ms(kern)
                p_ms, _ = time_ms(plain)
                timings[(op, dname, q)] = (k_ms, p_ms)
                nbytes = (F.data.numel() * F.data.element_size() + F.cols.numel() * 4
                          + 2 * n * q * X.element_size())
                b_ms, b_by = bound_ms(nbytes, 2 * F.data.numel() * q, dt)
                line = (f"[K2] {op:3s} {dname} q={q:3d}: rel err {rel_err:.2e} (abs {abs_err:.2e})"
                        f" | K2 {k_ms * 1e3:9.2f} us ({nbytes / (k_ms * 1e-3) / 1e12:.2f} TB/s,"
                        f" host {k_host * 1e3:.1f} us/call) | plain {p_ms * 1e3:9.2f} us"
                        f" | bound {b_ms * 1e3:8.2f} us ({b_by}, {share(b_ms, k_ms)})")
                if op == "mm":
                    check_close(f"torch.sparse {lib_name} {dname} q={q}", lib(X), plain(), dname)
                    library[(op, dname, q)] = time_ms(lambda: lib(X))[0]
                    line += f" | torch.sparse {lib_name} {library[(op, dname, q)] * 1e3:9.2f} us"
                log(line)
                if (op, dname, q) == ("mm", "float64", 48):
                    bound = (b_ms, b_by)
    return max_abs, timings, library, bound


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


# Phase 3's configuration: 3 pair-buffer Ros1 steps then 1 all-real-buffer
# step, τ = 10, capacity 96; phase 17a runs it again on row shards.
FULL_STEP_TAU = 10.0
FULL_STEP_CFG = CompiledConfig(maxiters=8, compression_interval=4, r_res=48)
FULL_STEP_ABSTOL = 1e-8
FULL_STEP_PLAN = ["pair"] * 3 + ["real"]
FULL_STEP_BUFFERS = {"pair": pair_encode_shifts(SHIFTS), "real": np.asarray([-0.5, -1.0, -2.0])}


def full_step_inputs(E, A, B, C, dev):
    """Phase 3's operands at full size on ``dev``: ``E``, ``A`` (DIA), ``B``,
    ``C`` and X0 = lowrank(E⁻¹Cᵀ, 0.01·I) at capacity 96."""
    dt = torch.float64
    E_op, A_op = dia_pencil(E, A, dtype=dt, device=dev)
    L0 = spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    X0 = lr_with_capacity(lowrank(torch.as_tensor(L0, dtype=dt, device=dev),
                                  0.01 * torch.eye(C.shape[0], dtype=dt, device=dev)),
                          CAPACITY)
    return (E_op, A_op, torch.as_tensor(B, dtype=dt, device=dev),
            torch.as_tensor(C, dtype=dt, device=dev), X0)


def step_ops(E_op, A_op):
    """The shifted operators of both of phase 3's buffers."""
    F_base = lin_comb(A_op, -1.0 / (2.0 * FULL_STEP_TAU), E_op)
    cache = {}
    return {name: build_dia_shift_ops(E_op, F_base, s, block_cache=cache)
            for name, s in FULL_STEP_BUFFERS.items()}


def run_full_steps(E_op, A_op, B_d, C_d, X0, ops):
    """Phase 3's 4 steps from X0, each with its wall (synchronized) and its
    K1 launches, Krylov iterations and collectives.  Returns the inputs of
    each step and rows (buffer, wall, ADI iterations, residual, X, K,
    launches, Krylov iterations, collectives)."""
    inputs, rows = [], []
    X = X0
    for name in FULL_STEP_PLAN:
        inputs.append(X)
        l0, s0 = k1.launches, blocklinear.krylov_iterations
        c0 = collections.Counter(mesh_mod.collectives)
        torch.cuda.synchronize()
        t = time.perf_counter()
        X, K, iters, res = ros1_step_compiled(E_op, A_op, B_d, C_d, X, FULL_STEP_TAU,
                                              FULL_STEP_BUFFERS[name], FULL_STEP_ABSTOL,
                                              FULL_STEP_CFG, ops[name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rows.append((name, wall, iters, float(res), X, K, k1.launches - l0,
                     blocklinear.krylov_iterations - s0,
                     dict(mesh_mod.collectives - c0)))
    return inputs, rows


def phase_full_step(E, A, B, C, dev):
    """The main path at full size: 3 pair-buffer Ros1 steps then 1
    all-real-buffer step.  Returns the K1 launches of the run."""
    tau, cfg = FULL_STEP_TAU, FULL_STEP_CFG
    t0 = time.perf_counter()
    E_op, A_op, B_d, C_d, X0 = full_step_inputs(E, A, B, C, dev)
    ops = step_ops(E_op, A_op)
    torch.cuda.synchronize()
    log(f"[n={N_FULL}] setup {time.perf_counter() - t0:.2f} s; Krylov: pair "
        f"{ops['pair'].cfg.method}, real {ops['real'].cfg.method}; "
        f"nnz {E_op.nnz}, offsets {E_op.offsets}")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the main path's run starts here
    blocklinear.krylov_iterations = 0
    inputs, rows = run_full_steps(E_op, A_op, B_d, C_d, X0, ops)
    launches = k1.launches  # the main path's run ends here
    fused = fused_path("dia_ros1")
    peak = torch.cuda.max_memory_allocated() / 2**30

    for j, (name, wall, iters, res, Xn, K, nl, ns, _) in enumerate(rows):
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
        f"run {launches}, the fused CG kernels' {fused}")
    check(fused > 0, f"[n={N_FULL}] the all-real step's CG did not launch the fused kernels")
    return launches


def ros2_problem(E, A, B, C, E_b, dev, nsteps, capacity):
    """The reference bench's north-star Ros2 problem on block-ELL operators
    ``E_b``: ``X0 = lowrank(E⁻¹Cᵀ, 0.01·I)`` at ``capacity``, ``nsteps``
    steps of τ = 10 from t = 4500, and 16 real Penzl shifts of the pencil
    ``(E, γτA − E/2)``.  Returns (problem, shifts, shift seconds)."""
    dt = torch.float64
    t0 = time.perf_counter()
    sv = heuristic_shifts_host(E, sp.csr_matrix(_ROS2_GAMMA * TAU * A - 0.5 * E), 16, 20, 20)
    t_shifts = time.perf_counter() - t0
    check(all(abs(v.imag) <= 1e-12 * abs(v) for v in sv), "Penzl shifts are not real")
    shifts = np.asarray([v.real for v in sv])
    L0 = spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    X0 = lr_with_capacity(lowrank(torch.as_tensor(L0, dtype=dt, device=dev),
                                  0.01 * torch.eye(C.shape[0], dtype=dt, device=dev)),
                          capacity)
    prob = GDREProblem(E_b[0], E_b[1], torch.as_tensor(B, dtype=dt, device=dev),
                       torch.as_tensor(C, dtype=dt, device=dev), X0,
                       (4500.0, 4500.0 - nsteps * TAU))
    return prob, shifts, t_shifts


def phase_bell_small():
    """The block-ELL Ros2 sweep at n=1357 (not a multiple of 128: the
    identity-padded last block) on the card and on the CPU: equal ADI
    iterations per step, K within 1e-9 at every stop."""
    E, A, B, C = rail_surrogate(N_SMALL)
    outs = []
    for dev in (CARD, "cpu"):
        E_b = bell_pencil(E, A, bs=BS, dtype=torch.float64, device=dev)
        prob, shifts, _ = ros2_problem(E, A, B, C, E_b, dev, SMALL_STEPS, SMALL_CAPACITY)
        steps = []
        before = k2.launches
        t0 = time.perf_counter()
        sol = solve_gdre_ros2_compiled(
            prob, dt=-TAU, shifts=shifts, cfg=SWEEP_CFG, capacity=SMALL_CAPACITY,
            observer=lambda i, X, K, iters, res: steps.append(iters))
        if dev == CARD:
            torch.cuda.synchronize()
            check(k2.launches > before, f"n={N_SMALL} sweep: K2 was not launched")
        outs.append(([K.cpu() for K in sol.K], steps))
        log(f"[n={N_SMALL}] {dev}: {SMALL_STEPS} Ros2 steps in {time.perf_counter() - t0:.3f} s, "
            f"ADI iters per step {steps[1:]}, worst res {sol.adi_res_max:.6e}, "
            f"rank {sol.X[-1].k}")
    (Kg, ig), (Kc, ic) = outs
    rel = [float(torch.linalg.norm(g - c) / torch.linalg.norm(c)) for g, c in zip(Kg, Kc)]
    log(f"[n={N_SMALL}] card vs CPU: K rel at each stop {['%.3e' % r for r in rel]}")
    check(ig == ic, f"n={N_SMALL}: ADI iterations differ (card {ig}, CPU {ic})")
    check(max(rel) <= STEP_REL_TOL, f"n={N_SMALL}: card and CPU K differ beyond {STEP_REL_TOL}")


def phase_bell_full(E, A, B, C, E_b, dev):
    """The block-ELL path at full size: `solve_gdre_ros2_compiled` on the
    n=79841 Rail surrogate in block-ELL, f64.  Returns the K2 launches of
    the run."""
    prob, shifts, t_shifts = ros2_problem(E, A, B, C, E_b, dev, FULL_STEPS, CAPACITY)
    log(f"[n={N_FULL} bell] Penzl shifts in {t_shifts:.2f} s: "
        + ", ".join(f"{v:.6e}" for v in shifts))
    rows = []
    mark = {}

    def observer(i, X, K, iters, res):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append((i, now - mark["t"], iters, None if res is None else float(res), X, K,
                     k2.launches - mark["k2"], blocklinear.krylov_iterations - mark["kry"]))
        mark.update(t=now, k2=k2.launches, kry=blocklinear.krylov_iterations)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the block-ELL path's run starts here
    blocklinear.krylov_iterations = 0
    mark.update(t=time.perf_counter(), k2=0, kry=0)
    t0 = mark["t"]
    sol = solve_gdre_ros2_compiled(prob, dt=-TAU, shifts=shifts, cfg=SWEEP_CFG,
                                   capacity=CAPACITY, save_state=True, observer=observer)
    torch.cuda.synchronize()
    launches, k1_launches = k2.launches, k1.launches  # the run ends here
    fused = fused_path("bell_ros2")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30

    log(f"[n={N_FULL} bell] sweep setup (shifted operators, block-Jacobi "
        f"inverses) {rows[0][1]:.3f} s; abstol n·eps·‖C‖_F")
    Eo, Ao = E_b
    for i, step_wall, iters, res, X, K, nl, ns in rows[1:]:
        R1 = lr_compress(_ros2_rhs1(Eo, Ao, prob.B, prob.C, sol.X[i - 1]), r_out=SWEEP_CFG.r_res)
        start = float(_residual_norm(R1.L, R1.D))
        finite = all(bool(torch.isfinite(t).all()) for t in (X.L, X.D, K))
        log(f"[n={N_FULL} bell] step {i}: wall {step_wall:.3f} s, ADI iters {iters}, "
            f"res {res:.6e} (stage-1 start {start:.6e}), rank {X.k}/{X.r}, "
            f"K2 launches {nl}, Krylov iterations (host syncs) {ns}")
        check(finite, f"bell step {i}: non-finite X or K")
        check(res < start, f"bell step {i}: residual {res:.3e} not below its start {start:.3e}")
        check(nl > 0, f"bell step {i}: K2 was not launched")
    log(f"[n={N_FULL} bell] {FULL_STEPS} steps in {wall:.3f} s (setup included); peak device "
        f"memory {peak:.2f} GiB; K2 launches in the run {launches}, K1 {k1_launches}, "
        f"the fused CG kernels' {fused}")
    check(fused > 0, f"[n={N_FULL} bell] the CG did not launch the fused kernels")
    return launches


def newton_problem(E, A, B, C, dev) -> GAREProblem:
    """The north-star GARE on the DIA pencil of (E, A): ``G = lowrank(1000·B)``,
    ``Q = lowrank(Cᵀ)``, f64 on ``dev``."""
    dt = torch.float64
    E_op, A_op = dia_pencil(E, A, dtype=dt, device=dev)
    return GAREProblem(E_op, A_op, lowrank(torch.as_tensor(1000.0 * B, dtype=dt, device=dev)),
                       lowrank(torch.as_tensor(C.T.copy(), dtype=dt, device=dev)))


def run_newton(prob, capacity, maxiters, observer=None):
    """`solve_gare_newton_compiled` in the north-star configuration.
    Returns (X, info, the solver's warnings counted by their text)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        X, info = solve_gare_newton_compiled(
            prob, shifts=NEWTON_SHIFTS, cfg=SWEEP_CFG, capacity=capacity,
            maxiters=maxiters, reltol=NEWTON_RELTOL, observer=observer)
    return X, info, collections.Counter(str(w.message) for w in caught)


def lr_rel_diff(Xa: LowRank, Xb: LowRank) -> float:
    """``‖Xa − Xb‖_F / ‖Xb‖_F`` without an n×n matrix: the difference is
    compressed first (QR of ``[La Lb]``), so the two terms cancel in a small
    matrix and not in the Gram trace, whose rounding floor is √eps."""
    d = lr_compress(lr_add(Xa, lr_scale(-1.0, Xb), r_out=Xa.r + Xb.r))
    return float(torch.linalg.norm(d.D) / lr_norm(Xb))


@contextlib.contextmanager
def shift_route(on_card: bool):
    """The Newton's closed-loop rebuilds pinned to one route
    (`compiled._shifts_on_card`) whatever the operators' device."""
    chosen = compiled._shifts_on_card
    compiled._shifts_on_card = lambda E, A: on_card
    try:
        yield
    finally:
        compiled._shifts_on_card = chosen


def phase_newton_small():
    """The Newton solve at n=1357 on the card (kernel path) and on the CPU
    (plain path), 20 Newton steps, both with their rebuilds on the card
    route (`heuristic_shifts_card`, on CPU tensors in the CPU run): equal
    steps, θs, rebuilds and ADI iterations; residuals, X and K within
    `NEWTON_REL_TOL`."""
    E, A, B, C = rail_surrogate(N_SMALL)
    outs = {}
    for dev in (CARD, "cpu"):
        prob = newton_problem(E, A, B, C, dev)
        before = k1.launches
        t0 = time.perf_counter()
        with shift_route(True):
            X, info, warned = run_newton(prob, CAPACITY, SMALL_NEWTON_MAXITERS)
        if dev == CARD:
            torch.cuda.synchronize()
            check(k1.launches > before, f"n={N_SMALL} Newton: K1 was not launched")
        wall = time.perf_counter() - t0
        K = feedback_K(prob.E, prob.G.L, X).cpu()
        outs[dev] = (LowRank(L=X.L.cpu(), D=X.D.cpu(), k=X.k), K, info)
        log(f"[n={N_SMALL} newton] {dev}: {wall:.3f} s, {info['newton_steps']} Newton steps, "
            f"ADI iters {info['adi_iters']}, rebuilds {info['shift_rebuilds']}, "
            f"sigma {info['sigma']:.6e}, thetas {['%.6e' % t for t in info['thetas']]}, "
            f"last rel residual {info['residuals'][-1] / info['residuals'][0]:.6e}, "
            f"rank {X.k}/{X.r}, warnings {dict(warned)}")
    (Xg, Kg, ig), (Xc, Kc, ic) = outs[CARD], outs["cpu"]
    for key in ("newton_steps", "shift_rebuilds", "adi_iters"):
        check(ig[key] == ic[key], f"n={N_SMALL} Newton: {key} differ (card {ig[key]}, CPU {ic[key]})")
    check(len(ig["thetas"]) == len(ic["thetas"])
          and np.allclose(ig["thetas"], ic["thetas"], rtol=NEWTON_REL_TOL, atol=0.0),
          f"n={N_SMALL} Newton: thetas differ (card {ig['thetas']}, CPU {ic['thetas']})")
    floor = N_SMALL * float(torch.finfo(torch.float64).eps) * ic["residuals"][0]
    check(len(ig["residuals"]) == len(ic["residuals"])
          and np.allclose(ig["residuals"], ic["residuals"], rtol=NEWTON_REL_TOL, atol=floor),
          f"n={N_SMALL} Newton: residual histories differ beyond {NEWTON_REL_TOL}")
    rel_X = lr_rel_diff(Xg, Xc)
    rel_K = float(torch.linalg.norm(Kg - Kc) / torch.linalg.norm(Kc))
    log(f"[n={N_SMALL} newton] card vs CPU: X rel {rel_X:.3e}, K rel {rel_K:.3e}")
    check(rel_X <= NEWTON_REL_TOL and rel_K <= NEWTON_REL_TOL,
          f"n={N_SMALL} Newton: card and CPU X or K differ beyond {NEWTON_REL_TOL}")


class StepLog(Observer):
    """At each Newton step's ``gare_step`` event: the host clock (after a
    synchronize), K1 launches, Krylov iterations, host seconds of shift
    rebuilds and the device memory, current and peak."""

    def __init__(self):
        self.rows = []

    def observe_gare_step(self, iter, X, residual, residual_norm):
        torch.cuda.synchronize()
        self.rows.append((iter, time.perf_counter(), k1.launches, blocklinear.krylov_iterations,
                          compiled.shift_rebuild_seconds, residual_norm, X.k,
                          torch.cuda.memory_allocated() / 2**30,
                          torch.cuda.max_memory_allocated() / 2**30))


def phase_newton_full(E, A, B, C, dev, capacity):
    """The Newton path at full size on the card, run to its end whatever the
    outcome.  Fails on an exception, a non-finite X, K or residual, or a
    last residual that an independent evaluation does not confirm.  Returns
    the K1 launches of the run."""
    t0 = time.perf_counter()
    prob = newton_problem(E, A, B, C, dev)
    torch.cuda.synchronize()
    log(f"[n={N_FULL} newton] DIA pencil on the card in {time.perf_counter() - t0:.2f} s; "
        f"capacity {capacity}, r_res {SWEEP_CFG.r_res}, reltol {NEWTON_RELTOL}, "
        f"maxiters {NEWTON_MAXITERS}, {NEWTON_SHIFTS}")
    steps = StepLog()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the Newton path's run starts here
    blocklinear.krylov_iterations = 0
    compiled.shift_rebuild_seconds = 0.0
    t0 = time.perf_counter()
    X, info, warned = run_newton(prob, capacity, NEWTON_MAXITERS, observer=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.launches  # the run ends here
    fused = fused_path("gare_newton")
    peak = torch.cuda.max_memory_allocated() / 2**30

    rows = steps.rows + [(None, t0 + wall, launches, blocklinear.krylov_iterations,
                          compiled.shift_rebuild_seconds, None, X.k, None, peak)]
    log(f"[n={N_FULL} newton] from solver start to the first step: {rows[0][1] - t0:.3f} s")
    for a, b in zip(rows, rows[1:]):
        log(f"[n={N_FULL} newton] step {a[0]}: residual {a[5]:.6e}, rank {a[6]}, then "
            f"{b[1] - a[1]:.3f} s, K1 launches {b[2] - a[2]}, Krylov iterations "
            f"{b[3] - a[3]}, rebuild host {b[4] - a[4]:.3f} s; memory {a[7]:.2f} GiB, "
            f"peak so far {a[8]:.2f} GiB")
    for text, count in warned.items():
        log(f"[n={N_FULL} newton] warning ({count}x): {text}")

    K = feedback_K(prob.E, prob.G.L, X)
    hist = info["residuals"]
    rel_solver = hist[-1] / hist[0]
    # The solver's last residual is that of the θ-stage problem it ended in
    # (G_θ = θ·G; θ = 1 unless it stopped inside the continuation).
    theta = info["thetas"][-1] if info["thetas"] else 1.0
    G_theta = LowRank(L=prob.G.L, D=theta * prob.G.D, k=prob.G.k)
    norm_Q = lr_norm(prob.Q)
    rel_ind = float(lr_norm(residual_gare_lowrank(prob.E, prob.A, G_theta, prob.Q, X)) / norm_Q)
    rel_full = float(lr_norm(residual_gare_lowrank(prob.E, prob.A, prob.G, prob.Q, X)) / norm_Q)
    log(f"[n={N_FULL} newton] converged {info['converged']}, final relative residual "
        f"{rel_solver:.6e} at theta {theta:.6e} (independent {rel_ind:.6e}); of the GARE "
        f"itself (theta 1) {rel_full:.6e}; target {NEWTON_RELTOL:g}")
    log(f"[n={N_FULL} newton] wall {wall:.3f} s, {info['newton_steps']} Newton steps, "
        f"ADI iters {info['adi_iters']} ({sum(info['adi_iters'])} in all), "
        f"{info['shift_rebuilds']} shift rebuilds ({compiled.shift_rebuild_seconds:.3f} s on the host)")
    log(f"[n={N_FULL} newton] sigma {info['sigma']:.6e}, {len(info['thetas'])} theta-stages "
        f"{['%.6e' % t for t in info['thetas']]}, line-search lambdas "
        f"{['%.3e' % lam for lam in info['linesearch_lams']]}")
    log(f"[n={N_FULL} newton] final rank {X.k}/{X.r} (capacity reached: {X.k == X.r}); "
        f"K1 launches {launches}, the fused CG kernels' {fused}, Krylov iterations "
        f"{blocklinear.krylov_iterations}; peak device memory {peak:.2f} GiB")
    check(fused > 0, f"[n={N_FULL} newton] the CG did not launch the fused kernels")
    log(f"[n={N_FULL} newton] residual history {['%.6e' % (h / hist[0]) for h in hist]}")
    finite = all(bool(torch.isfinite(t).all()) for t in (X.L, X.D, K))
    check(finite, "n=79841 Newton: non-finite X or K")
    check(bool(np.isfinite(hist).all()), "n=79841 Newton: non-finite residual")
    floor = N_FULL * float(torch.finfo(torch.float64).eps)  # the residual's rounding floor
    check(abs(rel_ind - rel_solver) <= RESIDUAL_AGREE_TOL * rel_solver + floor,
          f"n=79841 Newton: independent residual {rel_ind:.6e} differs from the "
          f"solver's {rel_solver:.6e} by more than {RESIDUAL_AGREE_TOL}")
    check(launches > 0, "n=79841 Newton: K1 was not launched")
    return launches


class HostLog(Observer):
    """The events of one public ``solve``: every ADI shift with the relative
    residual of its ADI when it was drawn, ADI solves, the last ADI solve's
    problem and its last residual, Newton residuals and line-search λs."""

    def __init__(self):
        self.shifts, self.gates, self.solve_of, self.newton, self.lams = [], [], [], [], []
        self.iters = []  # ADI iterations of each ADI solve
        self.rn0 = self.rn = None
        self.adi_solves = 0
        self.last_prob = self.last_done = None

    def observe_gale_start(self, prob, alg):
        self.adi_solves += 1
        self.last_prob = prob

    def observe_gale_step(self, iter, X, residual, residual_norm):
        if iter == 0:
            self.rn0 = residual_norm
        self.rn = residual_norm

    def observe_gale_metadata(self, desc, metadata):
        self.shifts.append(complex(metadata))
        self.gates.append(self.rn / self.rn0 if self.rn0 else 0.0)
        self.solve_of.append(self.adi_solves)

    def observe_gale_done(self, iters, X, residual, residual_norm):
        self.iters.append(iters)
        self.last_done = (X, residual_norm)

    def per_solve(self):
        """``[(shifts, gates)]`` of each ADI solve."""
        out = [([], []) for _ in range(self.adi_solves)]
        for z, g, k in zip(self.shifts, self.gates, self.solve_of):
            out[k - 1][0].append(z)
            out[k - 1][1].append(g)
        return out

    def observe_gare_step(self, iter, X, residual, residual_norm):
        self.newton.append(residual_norm)

    def observe_gare_metadata(self, desc, metadata):
        if desc == "line search":
            self.lams.append(metadata)


def canonical_pairs(shifts):
    """The shift sequence with each adjacent conjugate pair ordered by
    decreasing imaginary part: a pair's order is the eigensolver's and its
    double step does not depend on it."""
    out, i = [], 0
    while i < len(shifts):
        v = shifts[i]
        if (v.imag != 0 and i + 1 < len(shifts)
                and abs(shifts[i + 1] - v.conjugate()) <= 1e-8 * abs(v)):
            out += sorted(shifts[i:i + 2], key=lambda z: -z.imag)
            i += 2
        else:
            out.append(v)
            i += 1
    return out


def host_problem(kind, E, A, B, C, ops, tspan=ROS1_TSPAN):
    """The host-API problem ``kind`` (``gale``, ``ros1`` or ``newton``) on the
    pencil operators ``ops`` (on their device), f64; ``tspan``: the GDRE's."""
    Eo, Ao = ops
    dev = Eo.device

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=dev)

    if kind == "gale":
        return GALEProblem(Eo, Ao, lowrank(t(C.T)))
    if kind == "ros1":
        L0 = spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
        X0 = lowrank(t(L0), 0.01 * torch.eye(C.shape[0], dtype=torch.float64, device=dev))
        return GDREProblem(Eo, Ao, t(B), t(C), X0, tspan)
    return GAREProblem(Eo, Ao, lowrank(t(B)), lowrank(t(C.T)))


def run_host(kind, prob, alg):
    """One public ``solve`` (the GALE through ``init``) with a `HostLog`.
    Returns a dict: X, K (the last feedback, or None), wall, counts, the
    solver's residual and the right-hand side's norm it is relative to."""
    log_ = HostLog()
    dev = prob.E.device
    kry0, sol0 = blocklinear.krylov_iterations, blocklinear.krylov_solves
    arn0, syn0 = shift_mod.arnoldi_matvecs, shift_mod.arnoldi_syncs
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        K = None
        if kind == "gale":
            solver = init(prob, alg, observer=log_)
            X = solver.solve()
            res, rhs = solver.residual_norm, float(lr_norm(prob.C))
        elif kind == "ros1":
            sol = solve(prob, alg, dt=ROS1_DT, observer=log_)
            X, K = sol.X[-1], sol.K[-1]
            res, rhs = log_.last_done[1], float(lr_norm(log_.last_prob.C))
        else:
            X = solve(prob, alg, observer=log_)
            K = feedback_K(prob.E, prob.G.L, X)
            res, rhs = log_.newton[-1], float(lr_norm(prob.Q))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"X": X, "K": K, "log": log_, "wall": time.perf_counter() - t0,
            "krylov": blocklinear.krylov_iterations - kry0,
            "solves": blocklinear.krylov_solves - sol0,
            "arnoldi": (shift_mod.arnoldi_matvecs - arn0, shift_mod.arnoldi_syncs - syn0),
            "res": res, "rhs": rhs,
            "warnings": collections.Counter(str(w.message) for w in caught)}


def independent_residual(kind, prob, out):
    """The residual of the returned X evaluated anew (`residual`): of the
    GALE; of the last Ros1 step's GALE at that step's X; of the GARE at a
    recompressed copy of X (the solver's own is of X itself)."""
    if kind == "gale":
        return float(lr_norm(residual(prob, out["X"])))
    if kind == "ros1":
        return float(lr_norm(residual(out["log"].last_prob, out["log"].last_done[0])))
    return float(lr_norm(residual(prob, lr_compress(out["X"]))))


def confirm_residual(tag, kind, prob, out, n):
    """Fails unless the independent evaluation confirms the solver's
    residual: 1e-6 relative, or the floor (`HOST_FLOOR_FACTOR`·n·eps for
    the ADI's recursive residual, n·eps for Newton's own evaluation)."""
    ind = independent_residual(kind, prob, out)
    eps = float(torch.finfo(torch.float64).eps)
    floor = (n * eps if kind == "newton" else HOST_FLOOR_FACTOR * n * eps) * out["rhs"]
    log(f"{tag}: solver's residual {out['res'] / out['rhs']:.6e}, independent "
        f"{ind / out['rhs']:.6e} (relative to the right-hand side; floor "
        f"{floor / out['rhs']:.3e})")
    check(np.isfinite(ind) and np.isfinite(out["res"]), f"{tag}: non-finite residual")
    check(abs(ind - out["res"]) <= RESIDUAL_AGREE_TOL * out["res"] + floor,
          f"{tag}: independent residual {ind:.6e} does not confirm the solver's "
          f"{out['res']:.6e}")
    return ind


def compare_host(tag, card, cpu, tol):
    """Card vs CPU of one host-API solve: equal ADI solves, Newton steps and
    ADI iterations in each ADI solve, Krylov iterations within
    `KRYLOV_REL_TOL`, shift sequences (`SHIFT_REL_TOL` above `SHIFT_GATE`,
    the real/complex pattern below), X and K within ``tol``."""
    lg, lc = card["log"], cpu["log"]
    check(lg.adi_solves == lc.adi_solves, f"{tag}: ADI solves differ")
    check(lg.iters == lc.iters,
          f"{tag}: ADI iterations differ (card {lg.iters}, CPU {lc.iters})")
    rel, gated = [], []
    for (zg, _), (zc, gc) in zip(lg.per_solve(), lc.per_solve()):
        sg, sc = canonical_pairs(zg), canonical_pairs(zc)
        check([z.imag != 0 for z in sg] == [z.imag != 0 for z in sc],
              f"{tag}: real/complex shift patterns differ")
        r = [abs(a - b) / abs(b) for a, b in zip(sg, sc)]
        rel += r
        gated += [x for x, g in zip(r, gc) if g >= SHIFT_GATE]
    worst, worst_gated = max(rel, default=0.0), max(gated, default=0.0)
    rel_X = lr_rel_diff(card["X"], LowRank(L=cpu["X"].L.to(card["X"].L.device),
                                           D=cpu["X"].D.to(card["X"].L.device), k=cpu["X"].k))
    rel_K = (0.0 if cpu["K"] is None else
             float(torch.linalg.norm(card["K"].cpu() - cpu["K"]) / torch.linalg.norm(cpu["K"])))
    log(f"{tag} card vs CPU: ADI iterations {len(lg.shifts)}/{len(lc.shifts)} "
        f"(per ADI solve {lg.iters}/{lc.iters}), Krylov "
        f"{card['krylov']}/{cpu['krylov']}, Newton steps {len(lg.newton)}/{len(lc.newton)}, "
        f"shifts rel {worst_gated:.3e} ({len(gated)} drawn above {SHIFT_GATE:g}; all "
        f"{worst:.3e}), LDLᵀ rel {rel_X:.3e}, K rel {rel_K:.3e}; card {card['wall']:.3f} s, "
        f"CPU {cpu['wall']:.3f} s")
    check(abs(card["krylov"] - cpu["krylov"]) <= KRYLOV_REL_TOL * cpu["krylov"],
          f"{tag}: Krylov iterations differ beyond {KRYLOV_REL_TOL:.0%} (card "
          f"{card['krylov']}, CPU {cpu['krylov']})")
    check(len(lg.newton) == len(lc.newton), f"{tag}: Newton steps differ")
    check(np.allclose(lg.lams, lc.lams, rtol=1e-8, atol=0.0), f"{tag}: line-search λs differ")
    check(worst_gated <= SHIFT_REL_TOL, f"{tag}: shifts differ by {worst_gated:.3e}")
    check(rel_X <= tol and rel_K <= tol, f"{tag}: card and CPU differ beyond {tol}")


def phase_host_small():
    """The host API on the card and on the CPU, small (phase 8); the Ros1
    sweep cut to its first step (`SMALL_ROS1_TSPAN`)."""
    cases = (("gale", N_SMALL, ADI(shifts=SMALL_HOST_SHIFTS, maxiters=200), STEP_REL_TOL),
             ("ros1", N_TINY, Ros1(), STEP_REL_TOL),
             ("newton", N_TINY, Newton(ADI(ignore_initial_guess=True,
                                           shifts=Shifts.Projection(2)),
                                       maxiters=10, reltol=NEWTON_RELTOL), NEWTON_REL_TOL))
    for kind, n, alg, tol in cases:
        E, A, B, C = rail_surrogate(n)
        outs = {}
        for dev in (CARD, "cpu"):
            ops = dia_pencil(E, A, dtype=torch.float64, device=dev)
            before = k1.launches
            prob = host_problem(kind, E, A, B, C, ops, tspan=SMALL_ROS1_TSPAN)
            outs[dev] = run_host(kind, prob, alg)
            if dev == CARD:
                check(k1.launches > before, f"[host n={n} {kind}]: K1 was not launched")
        compare_host(f"[host n={n} {kind}]", outs[CARD], outs["cpu"], tol)


def phase_complex():
    """Complex shifted products through K1 and K2 against their plain
    versions, and one ADI double step card vs CPU (phase 9)."""
    E, A, B, C = rail_surrogate(N_SMALL)
    scale = float(np.mean(np.abs(A.diagonal())) / np.mean(np.abs(E.diagonal())))
    mu = complex(-1.0, 0.5) * scale
    rng = np.random.default_rng(3)
    worst = 0.0
    for fmt in ("dia", "bell"):
        kern = k1 if fmt == "dia" else k2

        def pencil(dev):
            if fmt == "dia":
                return dia_pencil(E, A, dtype=torch.float64, device=dev)
            return bell_pencil(E, A, bs=BS, dtype=torch.float64, device=dev)

        Eo, Ao = pencil(CARD)
        F = shifted_operator(Eo, Ao, mu)
        check(F.data.is_complex(), f"[complex {fmt}]: shifted operator is not complex")
        if fmt == "dia":
            def plain(X):
                return k1.dia_mm_plain(F.data, F.offsets, X)
        else:
            def plain(X):
                return k2.bell_mm_plain(F.cols, F.data, X)
        for q in (1, 7, 48):
            def arr(*shape):
                return torch.as_tensor(rng.standard_normal(shape), device=CARD)

            Xc = torch.complex(arr(N_SMALL, q), arr(N_SMALL, q))
            cases = [("complex op, complex X", lambda: F.mm(Xc), lambda: plain(Xc), 2),
                     ("complex op, real X", lambda: F.mm(Xc.real), lambda: plain(Xc.real), 2)]
            if fmt == "dia":
                Et = Eo.adjoint()
                cases += [("complex op, lane-major", lambda: F.mmT(Xc.T.contiguous()),
                           lambda: k1.dia_mm_t_plain(F.data, F.offsets, Xc.T.contiguous()), 2),
                          ("real op, complex X", lambda: Eo.tmm(Xc),
                           lambda: k1.dia_mm_plain(Et.data, Et.offsets, Xc), 1)]
            else:
                cases.append(("real op, complex X", lambda: Eo.tmm(Xc),
                              lambda: k2.bell_mm_plain(Eo.cols_t, Eo.data_t, Xc), 1))
            for name, run, ref, nl in cases:
                before = kern.launches
                y = run()
                launched = kern.launches - before
                r = ref()
                torch.cuda.synchronize()
                rel = float((y - r).abs().max() / r.abs().max())
                worst = max(worst, rel)
                log(f"[complex {fmt}] {name} q={q}: rel err {rel:.2e}, launches {launched}")
                check(bool(torch.isfinite(y).all()), f"[complex {fmt}] {name}: non-finite")
                check(launched == nl, f"[complex {fmt}] {name}: {launched} launches, expected {nl}")
                check(rel <= COMPLEX_REL_TOL, f"[complex {fmt}] {name} q={q}: rel err {rel:.3e}")
        # One ADI double step on the pair, card vs CPU.
        outs = {}
        for dev in (CARD, "cpu"):
            ops = (Eo, Ao) if dev == CARD else pencil(dev)
            prob = host_problem("gale", E, A, B, C, ops)
            solver = init(prob, ADI(shifts=Shifts.Cyclic((mu, mu.conjugate())), maxiters=2,
                                    warn_convergence=False))
            before = kern.launches
            solver.step()
            if dev == CARD:
                torch.cuda.synchronize()
                check(kern.launches > before, f"[complex {fmt}] double step: no launch")
            outs[dev] = (solver.X, solver.W.cpu(), kern.launches - before)
        rel_X = lr_rel_diff(outs[CARD][0], LowRank(L=outs["cpu"][0].L.to(CARD),
                                                   D=outs["cpu"][0].D.to(CARD), k=outs["cpu"][0].k))
        rel_W = float(torch.linalg.norm(outs[CARD][1] - outs["cpu"][1])
                      / torch.linalg.norm(outs["cpu"][1]))
        log(f"[complex {fmt}] ADI double step at mu = {mu:.6f} (and its conjugate): card vs "
            f"CPU LDLᵀ rel {rel_X:.3e}, W rel {rel_W:.3e}, launches {outs[CARD][2]}")
        check(rel_X <= STEP_REL_TOL and rel_W <= STEP_REL_TOL,
              f"[complex {fmt}] double step: card and CPU differ")
    return worst


def report_host(tag, kind, prob, out, n, kern):
    """Prints one full-size host-API solve and applies the failure rules;
    returns its launches of ``kern``."""
    lg = out["log"]
    X = out["X"]
    ncplx = sum(1 for z in lg.shifts if z.imag != 0)
    per = out["krylov"] / max(out["solves"], 1)
    log(f"{tag}: wall {out['wall']:.3f} s, ADI solves {lg.adi_solves}, ADI iterations "
        f"{len(lg.shifts)} ({len(lg.shifts) - ncplx} real shifts, {ncplx} complex), "
        f"Newton steps {max(len(lg.newton) - 1, 0)}, line-search λs "
        f"{['%.3e' % lam for lam in lg.lams]}, Krylov iterations {out['krylov']} in "
        f"{out['solves']} solves ({per:.1f} a solve), Arnoldi matvecs {out['arnoldi'][0]} "
        f"and host reads {out['arnoldi'][1]}, final rank {X.k}/{X.r}, "
        f"{'K1' if kern is k1 else 'K2'} launches {out['launches']}, "
        f"peak device memory {out['peak']:.2f} GiB")
    for text, count in out["warnings"].items():
        log(f"{tag} warning ({count}x): {text}")
    for name, (sec, calls) in sorted(out["timers"].items()):
        log(f"{tag} timer {name}: {sec:.3f} s in {calls} calls")
    finite = all(bool(torch.isfinite(t).all()) for t in (X.L, X.D)) and (
        out["K"] is None or bool(torch.isfinite(out["K"]).all()))
    check(finite, f"{tag}: non-finite output")
    confirm_residual(tag, kind, prob, out, n)
    check(out["launches"] > 0, f"{tag}: the kernel was not launched")
    return out["launches"]


def run_full_host(kind, prob, alg, kern, tag):
    """A full-size host-API run with its kernel's launches counted from 0 and
    the timers on; then its kernel against its plain version at every
    product the run fed it (`ProductLog`)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    reset_launches()  # this path's run starts here
    try:
        with ProductLog() as products:
            out = run_host(kind, prob, alg)
    finally:
        timers.enable(False)
    out["launches"] = kern.launches  # and ends here
    out["fused_launches"] = cg_fused.launches
    out["other_launches"] = (k2 if kern is k1 else k1).launches
    out["peak"] = torch.cuda.max_memory_allocated() / 2**30
    out["timers"] = timers.report()
    out["max_abs"] = products.check(tag)
    return out


def phase_host_full(E, A, B, C, dev):
    """The public ``solve`` at full size on the DIA pencil (phase 10)."""
    t0 = time.perf_counter()
    ops = dia_pencil(E, A, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    log(f"[host n={N_FULL} dia] DIA pencil on the card in {time.perf_counter() - t0:.2f} s")
    launches, worst = {}, 0.0
    runs = (("gale", ADI(shifts=HOST_SHIFTS), "gale_adi_host"),
            ("ros1", Ros1(), "gdre_ros1_host"),
            ("newton", Newton(ADI(ignore_initial_guess=True, shifts=HOST_SHIFTS),
                              maxiters=HOST_NEWTON_MAXITERS, reltol=NEWTON_RELTOL),
             "gare_newton_host"))
    for kind, alg, key in runs:
        prob = host_problem(kind, E, A, B, C, ops)
        tag = f"[host n={N_FULL} dia {kind}]"
        out = run_full_host(kind, prob, alg, k1, tag)
        launches[key] = report_host(tag, kind, prob, out, N_FULL, k1)
        FUSED_PATHS[key] = out["fused_launches"]
        check(out["other_launches"] == 0, f"{tag}: K2 launched on the DIA path")
        worst = max(worst, out["max_abs"]["K1"])
    return launches, worst


def phase_host_bell(E, A, B, C, E_b):
    """The README's GALE on the block-ELL pencil at full size (phase 11)."""
    prob = host_problem("gale", E, A, B, C, E_b)
    tag = f"[host n={N_FULL} bell gale]"
    out = run_full_host("gale", prob, ADI(shifts=HOST_SHIFTS), k2, tag)
    launches = report_host(tag, "gale", prob, out, N_FULL, k2)
    FUSED_PATHS["gale_adi_host_bell"] = out["fused_launches"]
    check(out["other_launches"] == 0, f"{tag}: K1 launched on the block-ELL path")
    return {"gale_adi_host_bell": launches}, out["max_abs"]["K2"]


def sign_flops(n: int, iters: int = SIGN_ITERS) -> float:
    """Operations of one `sign_function_cache` (n³ terms): E's LU (2n³/3)
    and M = A E⁻¹ (two triangular sweeps over n columns, 2n³), then per
    iteration an LU and an inversion (2n³/3 + 2n³)."""
    return (iters + 1) * (2.0 / 3.0 + 2.0) * n**3


def replay_flops(n: int, iters: int = SIGN_ITERS) -> float:
    """Operations of one `SignFunctionCache.solve`: C̃ = E⁻ᵀCE⁻¹ (two
    solves over n columns, 4n³), then two GEMMs per iteration (4n³)."""
    return (iters + 1) * 4.0 * n**3


def dense_flops(alg, n: int, nsteps: int) -> float:
    """Operations of ``nsteps`` dense Rosenbrock steps (n³ terms): per step
    one cache, one replay per stage and the stage right-hand sides' GEMMs."""
    return nsteps * (sign_flops(n) + DENSE_STAGES[alg] * replay_flops(n)
                     + DENSE_STEP_GEMMS[alg] * 2.0 * n**3)


class DenseSplit:
    """The device time of a dense run's sign iterations and of its
    C-replays, from CUDA events around each call of
    `lyapunov_dense._sign_iteration` and `lyapunov_dense._replay_rhs`
    (wrapped while the context is open; no host sync), and
    ‖M_final + I‖_F/√n of each sign iteration."""

    def __enter__(self):
        self._orig = sign, replay = lyapunov_dense._sign_iteration, lyapunov_dense._replay_rhs
        self.events = {"sign": [], "replay": []}
        self.gaps = []

        def timed(key, fn):
            def run(*args):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
                self.events[key].append((start, end))
                return out
            return run

        sign_timed = timed("sign", sign)

        def sign_iteration(M, maxiters):
            M_final, Minvs, cs_ = sign_timed(M, maxiters)
            n = M.shape[0]
            eye = torch.eye(n, dtype=M.dtype, device=M.device)
            self.gaps.append(torch.linalg.norm(M_final + eye) / n**0.5)
            return M_final, Minvs, cs_

        lyapunov_dense._sign_iteration = sign_iteration
        lyapunov_dense._replay_rhs = timed("replay", replay)
        return self

    def __exit__(self, *exc):
        lyapunov_dense._sign_iteration, lyapunov_dense._replay_rhs = self._orig
        return False

    def seconds(self, key: str) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[key]) / 1e3


def dense_gdre(n: int, dev):
    """The reference's dense GDRE on the n Rail surrogate, f64 on ``dev``:
    ``X0 = E⁻¹Cᵀ·0.01·C E⁻ᵀ``.  Returns (problem, E⁻¹Cᵀ)."""
    E, A, B, C = rail_surrogate_dense(n, device=dev)
    L0 = torch.linalg.solve(E, C.T)
    X0 = L0 @ (0.01 * torch.eye(C.shape[0], dtype=torch.float64, device=dev)) @ L0.T
    return GDREProblem(E, A, B, C, X0, ROS1_TSPAN), L0


def rel_diff(a, b) -> float:
    return float(torch.linalg.norm(a - b.to(a.device)) / torch.linalg.norm(b))


def phase_dense_small():
    """The dense path on the card and on the CPU, small (phase 12): the GALE
    by the sign function and by the SciPy oracle (n=371), by Kronecker
    (n=40), and the dense GDRE by Ros1 to Ros4 (n=371); X and every K
    within `DENSE_REL_TOL`."""
    outs = {}
    for dev in (CARD, "cpu"):
        E, A, B, C = rail_surrogate_dense(N_TINY, device=dev)
        gale = GALEProblem(E, A, C.T @ C)
        got = {name: (solve(gale, alg),) for name, alg in (
            ("gale sign", BartelsStewart()), ("gale host", BartelsStewart(host=True)))}
        for X, in got.values():
            check(X.device == E.device, f"[dense n={N_TINY}] a GALE solve left {dev}")
            res = float(torch.linalg.norm(residual(gale, X)) / torch.linalg.norm(gale.C))
            check(res <= GALE_RES_TOL, f"[dense n={N_TINY}] GALE residual {res:.3e} on {dev}")
        Ek, Ak, _, Ck = rail_surrogate_dense(N_KRON, device=dev)
        got[f"gale kronecker n={N_KRON}"] = (solve(GALEProblem(Ek, Ak, Ck.T @ Ck), Kronecker()),)
        prob, _ = dense_gdre(N_TINY, dev)
        for alg in DENSE_ALGS:
            sol = solve(prob, alg(), dt=ROS1_DT)
            got[f"gdre {alg.__name__}"] = (sol.X[-1], *sol.K)
        outs[dev] = got
    for name, card in outs[CARD].items():
        rels = [rel_diff(c.cpu(), h) for c, h in zip(card, outs["cpu"][name])]
        log(f"[dense n={N_TINY}] {name} card vs CPU: X rel {rels[0]:.3e}"
            + (f", K rel (max over {len(rels) - 1} stops) {max(rels[1:]):.3e}" if rels[1:] else ""))
        check(all(np.isfinite(r) and r <= DENSE_REL_TOL for r in rels),
              f"[dense n={N_TINY}] {name}: card and CPU differ beyond {DENSE_REL_TOL}")


def run_dense(tag: str, fn, flops: float):
    """One full-size dense run: the wall ending in `torch.cuda.synchronize()`,
    the peak device memory, the device time of its sign iterations and its
    replays, its share of the f64 operations bound and the sign iterations'
    convergence (`SIGN_GAP_TOL`).  Returns ``fn()``'s result."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with DenseSplit() as split:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    sign_s, replay_s = split.seconds("sign"), split.seconds("replay")
    gaps = [float(g) for g in split.gaps]
    bound = flops / PEAK_FLOP_S[torch.float64]
    log(f"{tag}: wall {wall:.3f} s, peak device memory {peak:.2f} GiB; sign iterations "
        f"{sign_s:.3f} s ({len(split.events['sign'])} of {SIGN_ITERS} steps), replays "
        f"{replay_s:.3f} s ({len(split.events['replay'])}), the rest {wall - sign_s - replay_s:.3f} s; "
        f"{flops:.4g} flop, bound {bound:.3f} s ({share(bound, wall)} of the wall at "
        f"67 TFLOP/s); ‖M_final + I‖_F/√n at most {max(gaps):.3e}")
    check(all(np.isfinite(g) and g <= SIGN_GAP_TOL for g in gaps),
          f"{tag}: a sign iteration did not converge (‖M_final + I‖_F/√n {max(gaps):.3e})")
    return out


def phase_dense_full():
    """The dense path at full size, n=5177 (phase 13): the GALE, the dense
    GDRE by Ros1 to Ros4, the low-rank Ros1 and Ros2 on the DIA pencil
    (through K1) against them, and the compiled Ros2 sweep on dense cores
    (`ShiftLUs`).  Returns K1's launches per low-rank run."""
    n = N_DENSE
    eps = float(torch.finfo(torch.float64).eps)
    log(f"[dense n={n}] TF32 in matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"float32 matmul precision {torch.get_float32_matmul_precision()}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t0 = time.perf_counter()
    prob, L0 = dense_gdre(n, CARD)
    torch.cuda.synchronize()
    log(f"[dense n={n}] dense Rail surrogate on the card in {time.perf_counter() - t0:.2f} s")

    gale = GALEProblem(prob.E, prob.A, prob.C.T @ prob.C)
    X = run_dense(f"[dense n={n} gale]", lambda: solve(gale, BartelsStewart()),
                  sign_flops(n) + replay_flops(n))
    res = float(torch.linalg.norm(residual(gale, X)) / torch.linalg.norm(gale.C))
    log(f"[dense n={n} gale] relative residual {res:.6e}")
    check(bool(torch.isfinite(X).all()) and res <= GALE_RES_TOL,
          f"[dense n={n} gale]: relative residual {res:.3e} above {GALE_RES_TOL}")
    del X, gale

    nsteps = round((ROS1_TSPAN[1] - ROS1_TSPAN[0]) / ROS1_DT)
    K_dense = {}
    for alg in DENSE_ALGS:
        tag = f"[dense n={n} {alg.__name__}]"
        sol = run_dense(tag, lambda: solve(prob, alg(), dt=ROS1_DT),
                        dense_flops(alg, n, nsteps))
        check(len(sol.K) == nsteps + 1 and all(bool(torch.isfinite(K).all()) for K in sol.K)
              and bool(torch.isfinite(sol.X[-1]).all()), f"{tag}: non-finite or missing output")
        K_dense[alg] = sol.K[-1]
        del sol
    ref = K_dense[Ros4]
    for alg in (Ros1, Ros2, Ros3):
        rel = rel_diff(K_dense[alg], ref)
        log(f"[dense n={n}] {alg.__name__} vs Ros4: K rel {rel:.3e} (orders 2-3 held to {ORDER_TOL})")
        check(alg is Ros1 or rel <= ORDER_TOL, f"[dense n={n}] {alg.__name__} and Ros4 part by {rel:.3e}")

    E_sp, A_sp, _, _ = rail_surrogate(n)
    E_op, A_op = dia_pencil(E_sp, A_sp, dtype=torch.float64, device=CARD)
    X0 = lowrank(L0, 0.01 * torch.eye(L0.shape[1], dtype=torch.float64, device=CARD))
    lr_prob = GDREProblem(E_op, A_op, prob.B, prob.C, X0, ROS1_TSPAN)
    launches = {}
    for alg in (Ros1, Ros2):
        tag = f"[dense n={n} low-rank {alg.__name__}]"
        torch.cuda.synchronize()
        k1.launches = 0  # this path's run starts here
        t0 = time.perf_counter()
        sol = solve(lr_prob, alg(), dt=ROS1_DT)
        torch.cuda.synchronize()
        launches[f"dense_check_lowrank_{alg.__name__.lower()}"] = nl = k1.launches  # and ends here
        wall = time.perf_counter() - t0
        dK = float(torch.linalg.norm(sol.K[-1] - K_dense[alg]))
        tol = float(torch.linalg.norm(K_dense[alg])) * n * eps * 100
        log(f"{tag}: wall {wall:.3f} s, rank {sol.X[-1].k}, K1 launches {nl}; "
            f"‖K_lowrank − K_dense‖_F {dK:.3e} (limit ‖K‖·n·eps·100 = {tol:.3e}; "
            f"relative {dK / (tol / (n * eps * 100)):.3e})")
        check(dK <= tol, f"{tag}: K differs from the dense solver's by {dK:.3e} > {tol:.3e}")
        check(nl > 0, f"{tag}: K1 was not launched")
    del E_op, A_op, lr_prob

    tau = -ROS1_DT
    sv = heuristic_shifts_host(E_sp, sp.csr_matrix(_ROS2_GAMMA * tau * A_sp - 0.5 * E_sp),
                               16, 20, 20)
    check(all(abs(v.imag) <= 1e-12 * abs(v) for v in sv), "Penzl shifts are not real")
    shifts = np.asarray([v.real for v in sv])
    tag = f"[dense n={n} compiled Ros2 on dense cores]"
    check(isinstance(prob.E, DenseOp) and isinstance(prob.A, DenseOp), f"{tag}: not dense cores")
    cprob = GDREProblem(prob.E, prob.A, prob.B, prob.C,
                        lr_with_capacity(X0, DENSE_SWEEP_CAPACITY), ROS1_TSPAN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = solve_gdre_ros2_compiled(cprob, dt=ROS1_DT, shifts=shifts, cfg=DENSE_SWEEP_CFG,
                                   capacity=DENSE_SWEEP_CAPACITY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dK = float(torch.linalg.norm(sol.K[-1] - K_dense[Ros2]))
    tol = float(torch.linalg.norm(K_dense[Ros2])) * n * eps * 100
    log(f"{tag}: {nsteps} steps in {wall:.3f} s (16 shifted LUs included), ADI iterations "
        f"{sol.adi_iters}, worst residual {sol.adi_res_max:.6e}, rank {sol.X[-1].k}/"
        f"{sol.X[-1].r}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"‖K − K_dense‖_F {dK:.3e} (limit {tol:.3e})")
    check(dK <= tol, f"{tag}: K differs from the dense Ros2's by {dK:.3e} > {tol:.3e}")
    return launches


# --- phases 14 and 15: GMRES and the mixed-precision core --------------------------


def reset_launches():
    """Every launch count of K1, K2 and the fused CG kernels to 0 (a path's
    run starts here)."""
    for kern in (k1, k2):
        kern.launches = 0
        kern.launches_by_dtype.update({torch.float64: 0, torch.float32: 0})
    cg_fused.launches = 0


#: The fused CG kernels' launches of each main path (`fused_path`), for the
#: kernels line's ``cg_fused`` entry.
FUSED_PATHS: dict[str, int] = {}


def fused_path(key) -> int:
    """Records under ``key`` the fused CG kernels' launches since the last
    `reset_launches` (a path's run ends here) and returns them."""
    FUSED_PATHS[key] = cg_fused.launches
    return FUSED_PATHS[key]


def dtype_launches(kern) -> dict:
    """``{"f64": n, "f32": m}`` of ``kern`` since the last `reset_launches`."""
    return {"f64": kern.launches_by_dtype[torch.float64],
            "f32": kern.launches_by_dtype[torch.float32]}


class GaleLog(Observer):
    """The events of one FGMRES GALE solve: its own ``gale_step`` events (the
    nested ADI solves of an ADI preconditioner excluded), its cycles and
    Krylov vectors, and the ADI iterations of its preconditioner's solves."""

    def __init__(self):
        self.steps, self.cycles, self.vectors, self.adi_iters = [], 0, 0, []
        self.depth = 0
        self.rn = None

    def observe_gale_start(self, prob, alg):
        self.depth += 1

    def observe_gale_step(self, iter, X, residual, residual_norm):
        if self.depth != 1:
            return
        self.steps.append((iter, residual_norm))
        if iter == 0 and X is not None and residual is not None:
            self.cycles += 1
        elif X is not None and residual is None:  # a cycle's end: m vectors
            self.vectors += iter
        self.rn = residual_norm

    def observe_gale_done(self, iters, X, residual, residual_norm):
        if self.depth > 1:
            self.adi_iters.append(iters)
        self.depth -= 1


def run_fgmres_gale(prob):
    """One public ``solve(prob, GALE_FGMRES)`` with a `GaleLog`; its wall
    ends in a synchronize."""
    glog = GaleLog()
    sync = prob.E.device.type == "cuda"
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    X = solve(prob, GALE_FGMRES, observer=glog)
    if sync:
        torch.cuda.synchronize()
    return X, glog, time.perf_counter() - t0


def run_fgmres_newton(prob, maxiters):
    """`solve_gare_newton_compiled` with inner FGMRES under the capped
    compiled ADI (``bench.py``'s Newton+FGMRES family at capacity 192)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        X, info = solve_gare_newton_compiled(
            prob, shifts=NEWTON_SHIFTS, cfg=FGMRES_CFG, capacity=FGMRES_CAPACITY,
            maxiters=maxiters, reltol=FGMRES_RELTOL, inner_gmres=NEWTON_FGMRES)
    return X, info, collections.Counter(str(w.message) for w in caught)


def check_history(tag, got, ref, rtol, atol):
    """Residual histories of equal length within ``rtol`` relative or
    ``atol``; logs the largest relative gap."""
    got, ref = np.asarray(got), np.asarray(ref)
    check(got.shape == ref.shape, f"{tag}: histories of {got.size} and {ref.size} entries")
    gap = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300))) if ref.size else 0.0
    check(bool(np.all(np.abs(got - ref) <= rtol * np.abs(ref) + atol)),
          f"{tag}: residual histories differ beyond {rtol:g} (largest gap {gap:.3e})")
    return gap


def phase_gmres_small():
    """GMRES card vs CPU (phase 14, small): `Krylov(method="gmres")` on one
    shifted DIA operator and the host FGMRES GALE at n=1357, the compiled
    Newton+FGMRES at n=371."""
    E, A, B, C = rail_surrogate(N_SMALL)
    rng = np.random.default_rng(14)
    W = rng.standard_normal((N_SMALL, 7))
    sols = {}
    for dev in (CARD, "cpu"):
        F = shifted_dia(*dia_pencil(E, A, dtype=torch.float64, device=dev), -1.0)
        kry0 = blocklinear.krylov_iterations
        sols[dev] = (blocklinear.prepare(F, GMRES_KRYLOV).solve(torch.as_tensor(W, device=dev)),
                     blocklinear.krylov_iterations - kry0)
    rel = rel_diff(sols[CARD][0].cpu(), sols["cpu"][0])
    log(f"[gmres n={N_SMALL}] Krylov(method='gmres', restart 20, maxiter 3) on Aᵀ − Eᵀ: "
        f"card vs CPU rel {rel:.3e}, host reads {sols[CARD][1]}/{sols['cpu'][1]}")
    check(rel <= GMRES_REL_TOL and sols[CARD][1] == sols["cpu"][1],
          f"[gmres n={N_SMALL}] Krylov GMRES: card and CPU differ")

    outs = {}
    for dev in (CARD, "cpu"):
        prob = host_problem("gale", E, A, B, C, dia_pencil(E, A, dtype=torch.float64, device=dev))
        before = k1.launches
        X, glog, wall = run_fgmres_gale(prob)
        if dev == CARD:
            check(k1.launches > before, f"[gmres n={N_SMALL}] FGMRES GALE: K1 was not launched")
        outs[dev] = (X, glog, wall, float(lr_norm(prob.C)))
    (Xg, lg, wg, nC), (Xc, lc, wc, _) = outs[CARD], outs["cpu"]
    rel_X = lr_rel_diff(Xg, LowRank(L=Xc.L.to(CARD), D=Xc.D.to(CARD), k=Xc.k))
    floor = math.sqrt(float(torch.finfo(torch.float64).eps)) * nC
    gap = check_history(f"[gmres n={N_SMALL}] FGMRES GALE", [r for _, r in lg.steps],
                        [r for _, r in lc.steps], GMRES_HIST_TOL, floor)
    log(f"[gmres n={N_SMALL}] FGMRES GALE card vs CPU: {lg.cycles}/{lc.cycles} cycles, "
        f"{lg.vectors}/{lc.vectors} Krylov vectors, events {[i for i, _ in lg.steps]}, "
        f"preconditioner ADI iterations {lg.adi_iters}/{lc.adi_iters}, final relative "
        f"residual {lg.rn / nC:.6e}/{lc.rn / nC:.6e}, histories rel gap {gap:.3e}, LDLᵀ rel "
        f"{rel_X:.3e}; card {wg:.3f} s, CPU {wc:.3f} s")
    check([i for i, _ in lg.steps] == [i for i, _ in lc.steps] and lg.adi_iters == lc.adi_iters,
          f"[gmres n={N_SMALL}] FGMRES GALE: event sequences differ")
    check(rel_X <= GMRES_REL_TOL, f"[gmres n={N_SMALL}] FGMRES GALE: LDLᵀ differ by {rel_X:.3e}")

    E, A, B, C = rail_surrogate(N_TINY)
    outs = {}
    for dev in (CARD, "cpu"):
        prob = newton_problem(E, A, B, C, dev)
        t0 = time.perf_counter()
        X, info, _ = run_fgmres_newton(prob, NEWTON_MAXITERS)
        if dev == CARD:
            torch.cuda.synchronize()
        outs[dev] = (LowRank(L=X.L.cpu(), D=X.D.cpu(), k=X.k), info, time.perf_counter() - t0)
    (Xg, ig, wg), (Xc, ic, wc) = outs[CARD], outs["cpu"]
    rel_X = lr_rel_diff(Xg, Xc)
    for dev, info in (("card", ig), ("CPU", ic)):
        h = info["residuals"]
        log(f"[gmres n={N_TINY}] Newton+FGMRES {dev}: thetas {info['thetas']}, lambdas "
            f"{info['linesearch_lams']}, history {['%.6e' % (x / h[0]) for x in h]}")
    log(f"[gmres n={N_TINY}] Newton+FGMRES card vs CPU: X rel {rel_X:.3e}")
    gap = check_history(f"[gmres n={N_TINY}] Newton+FGMRES", ig["residuals"], ic["residuals"],
                        FGMRES_NEWTON_HIST_TOL, FGMRES_RELTOL * ic["residuals"][0])
    log(f"[gmres n={N_TINY}] Newton+FGMRES card vs CPU: Newton steps "
        f"{ig['newton_steps']}/{ic['newton_steps']}, rebuilds {ig['shift_rebuilds']}/"
        f"{ic['shift_rebuilds']}, converged {ig['converged']}/{ic['converged']}, last relative "
        f"residual {ig['residuals'][-1] / ig['residuals'][0]:.6e}/"
        f"{ic['residuals'][-1] / ic['residuals'][0]:.6e}, histories rel gap {gap:.3e}, X rel "
        f"{rel_X:.3e}; card {wg:.3f} s, CPU {wc:.3f} s")
    for key in ("newton_steps", "shift_rebuilds", "converged"):
        check(ig[key] == ic[key], f"[gmres n={N_TINY}] Newton+FGMRES: {key} differ")
    check(rel_X <= FGMRES_X_TOL, f"[gmres n={N_TINY}] Newton+FGMRES: X differ by {rel_X:.3e}")


def timer_lines(tag):
    for name, (sec, calls) in sorted(timers.report().items()):
        log(f"{tag} timer {name}: {sec:.3f} s in {calls} calls")


def report_newton(tag, prob, X, info, wall, launches, peak, n):
    """Prints one compiled Newton run and applies phase 7's failure rules:
    non-finite output, or a last residual that the independent evaluation
    does not confirm."""
    hist = info["residuals"]
    rel_solver = hist[-1] / hist[0]
    theta = info["thetas"][-1] if info["thetas"] else 1.0
    G_theta = LowRank(L=prob.G.L, D=theta * prob.G.D, k=prob.G.k)
    norm_Q = lr_norm(prob.Q)
    rel_ind = float(lr_norm(residual_gare_lowrank(prob.E, prob.A, G_theta, prob.Q, X)) / norm_Q)
    log(f"{tag}: wall {wall:.3f} s, {info['newton_steps']} Newton steps, converged "
        f"{info['converged']}, final relative residual {rel_solver:.6e} at theta {theta:.3e} "
        f"(independent {rel_ind:.6e}), {info['shift_rebuilds']} shift rebuilds, ADI iters "
        f"{sum(i for i in info['adi_iters'] if i > 0)} ({info['adi_iters'][:8]}...), final rank "
        f"{X.k}/{X.r}, K1 launches {launches}, Krylov iterations {info.get('krylov', 0)}, "
        f"peak device memory {peak:.2f} GiB")
    log(f"{tag}: residual history {['%.3e' % (h / hist[0]) for h in hist]}")
    K = feedback_K(prob.E, prob.G.L, X)
    check(all(bool(torch.isfinite(t).all()) for t in (X.L, X.D, K)), f"{tag}: non-finite X or K")
    check(bool(np.isfinite(hist).all()), f"{tag}: non-finite residual")
    floor = n * float(torch.finfo(torch.float64).eps)
    check(abs(rel_ind - rel_solver) <= RESIDUAL_AGREE_TOL * rel_solver + floor,
          f"{tag}: independent residual {rel_ind:.6e} does not confirm the solver's "
          f"{rel_solver:.6e}")


def phase_gmres_full(E, A, B, C, dev):
    """GMRES at full size (phase 14): the README's GALE under FGMRES through
    the public ``solve``; the compiled Newton+FGMRES, its depth cut to
    `FGMRES_FULL_MAXITERS` steps, and the same solve at n=1357 (at most
    `FGMRES_SMALL_MAXITERS` steps).
    Returns K1's launches per path, by dtype."""
    launches = {}
    tag = f"[gmres n={N_FULL} gale]"
    prob = host_problem("gale", E, A, B, C, dia_pencil(E, A, dtype=torch.float64, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    reset_launches()  # this path's run starts here
    kry0 = blocklinear.krylov_iterations
    try:
        X, glog, wall = run_fgmres_gale(prob)
    finally:
        timers.enable(False)
    launches["gmres_gale_host"] = dtype_launches(k1)  # and ends here
    k2_n = k2.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    nC = float(lr_norm(prob.C))
    ind = float(lr_norm(residual(prob, X)))
    log(f"{tag}: wall {wall:.3f} s, {glog.cycles} cycles, {glog.vectors} Krylov vectors, "
        f"events {[i for i, _ in glog.steps]}, preconditioner ADI iterations {glog.adi_iters}, "
        f"Krylov iterations {blocklinear.krylov_iterations - kry0}, final rank {X.k}/{X.r}, "
        f"K1 launches {launches['gmres_gale_host']}, peak device memory {peak:.2f} GiB")
    log(f"{tag}: relative residual history {['%.3e' % (r / nC) for _, r in glog.steps]}")
    log(f"{tag}: solver's final residual {glog.rn / nC:.6e}, independent {ind / nC:.6e} "
        f"(relative to ‖C‖); target {GALE_FGMRES.reltol:g}")
    timer_lines(tag)
    check(all(bool(torch.isfinite(t).all()) for t in (X.L, X.D)), f"{tag}: non-finite X")
    check(np.isfinite(ind) and abs(ind - glog.rn) <= RESIDUAL_AGREE_TOL * glog.rn
          + N_FULL * float(torch.finfo(torch.float64).eps) * nC,
          f"{tag}: independent residual {ind:.6e} does not confirm the solver's {glog.rn:.6e}")
    check(launches["gmres_gale_host"]["f64"] > 0 and k2_n == 0, f"{tag}: K1 not launched, or K2")
    del X, prob

    for n, maxiters, key in ((N_FULL, FGMRES_FULL_MAXITERS, "gare_newton_fgmres"),
                             (N_SMALL, FGMRES_SMALL_MAXITERS, "gare_newton_fgmres_n1357")):
        En, An, Bn, Cn = (E, A, B, C) if n == N_FULL else rail_surrogate(n)
        tag = f"[gmres n={n} newton]"
        prob = newton_problem(En, An, Bn, Cn, dev)
        log(f"{tag}: capacity {FGMRES_CAPACITY}, {FGMRES_CFG}, reltol {FGMRES_RELTOL:g}, "
            f"{NEWTON_SHIFTS}, {NEWTON_FGMRES}; Newton steps capped at {maxiters}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # this path's run starts here
        kry0 = blocklinear.krylov_iterations
        t0 = time.perf_counter()
        X, info, warned = run_fgmres_newton(prob, maxiters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[key] = dtype_launches(k1)  # and ends here
        info["krylov"] = blocklinear.krylov_iterations - kry0
        report_newton(tag, prob, X, info, wall, launches[key],
                      torch.cuda.max_memory_allocated() / 2**30, n)
        for text, count in warned.items():
            log(f"{tag} warning ({count}x): {text}")
        check(launches[key]["f64"] > 0, f"{tag}: K1 was not launched")
        del X, prob
    return launches


def mixed_krylov(refine_iters=3):
    """The f32-core Krylov configuration of ``bench.py``'s mixed GALE
    (real shifts: CG on the negated operator)."""
    return dataclasses.replace(default_dia_krylov(torch.float64, False),
                               solve_dtype="float32", refine_iters=refine_iters)


_PENZL = {}  # the 16 Penzl shifts of the pencil, by size (host only)


def run_gale_mixed(E, A, C, dev, solve_dtype, mesh=None):
    """``bench.py``'s ``substage_gale_mixed`` on ``dev``: 16 Penzl shifts,
    the compiled ADI (`MIXED_GALE_CFG`, capacity 160, abstol 1e-10·‖C‖)
    with an f32 core and 3 refinements (``solve_dtype="float32"``) or the
    f64 core (``None``); on DIA row shards over ``mesh`` if given.  Returns
    a dict of its results (``X`` gathered)."""
    n = E.shape[0]
    t0 = time.perf_counter()
    if n not in _PENZL:
        _PENZL[n] = np.asarray([v.real for v in heuristic_shifts_host(E, A, 16, 20, 20)])
    shifts = _PENZL[n]
    Eo, Ao = dia_pencil(E, A, dtype=torch.float64, device=dev)
    Ct = torch.as_tensor(np.ascontiguousarray(C.T), device=dev)
    X0 = lr_zero(n, MIXED_GALE_CAPACITY, torch.float64, dev)
    if mesh is not None:
        Eo, Ao = (shard_operator(mesh, op, block=PREC_BS) for op in (Eo, Ao))
        Ct, X0 = shard_tall(mesh, Ct, PREC_BS), shard_lowrank(mesh, X0, PREC_BS)
    kry = dataclasses.replace(mixed_krylov(), solve_dtype=solve_dtype)
    with mesh_mod.use_mesh(mesh):
        lus = build_dia_shift_ops(Eo, Ao, shifts, krylov_cfg=kry)
        Cf = lowrank(Ct)
        norm_c = float(lr_norm(Cf))
        res0 = residual_gale_lowrank(Eo, Ao, Cf, X0, r_out=MIXED_GALE_CFG.r_res)
        if dev != "cpu":
            torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        kry0, sol0 = blocklinear.krylov_iterations, blocklinear.krylov_solves
        t0 = time.perf_counter()
        X, _, iters, res = compiled.adi_compiled(
            Eo, Ao, _mask_cols(res0.L, res0.k), res0.D, res0.k, X0, shifts, 1e-10 * norm_c,
            MIXED_GALE_CFG, lus)
        if dev != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        true = float(lr_norm(residual_gale_lowrank(Eo, Ao, Cf, X,
                                                   r_out=2 * MIXED_GALE_CFG.r_res)))
    if mesh is not None:
        X = LowRank(L=unshard_tall(mesh, X.L, n, PREC_BS), D=X.D, k=X.k)
    return {"X": X, "iters": iters, "tracked": float(res) / norm_c, "true": true / norm_c,
            "wall": wall, "setup": setup, "krylov": blocklinear.krylov_iterations - kry0,
            "solves": blocklinear.krylov_solves - sol0, "prec_dtype": lus.prec_inv.dtype}


def refined_cases(E, A, dev):
    """The refined solvers of phase 15 on ``dev`` at the pencil of (E, A):
    one real and one pair slot of a pair-encoded DIA shift buffer (f32 core,
    3 refinements) and the refined block-ELL solve of ``Aᵀ + μEᵀ``."""
    scale = float(np.mean(np.abs(A.diagonal())) / np.mean(np.abs(E.diagonal())))
    buf = np.asarray([[-scale, 0.0], [-scale, 0.5 * scale]])
    Eo, Ao = dia_pencil(E, A, dtype=torch.float64, device=dev)
    kry = dataclasses.replace(default_dia_krylov(torch.float64, True), solve_dtype="float32",
                              refine_iters=3)
    ops = build_dia_shift_ops(Eo, Ao, buf, krylov_cfg=kry)
    Eb, Ab = bell_pencil(E, A, bs=BS, dtype=torch.float64, device=dev)
    return {"dia real slot": ops.core_solver(0),
            "dia pair slot": ops.pair_solver(1, float(buf[1, 1])),
            "bell": blocklinear.prepare(shifted_bell(Eb, Ab, -scale), MIXED_BELL_KRYLOV)}


def phase_mixed_small():
    """The mixed-precision core card vs CPU at n=1357 (phase 15, small): the
    refined solvers on a real and a pair DIA slot and on block-ELL, and the
    compiled GALE with the f32 core."""
    E, A, B, C = rail_surrogate(N_SMALL)
    rng = np.random.default_rng(15)
    W = rng.standard_normal((N_SMALL, 7))
    outs = {}
    for dev in (CARD, "cpu"):
        got = {}
        for name, solver in refined_cases(E, A, dev).items():
            check(isinstance(solver, blocklinear.RefinedKrylovSolver)
                  and solver.inner.op.dtype == torch.float32, f"[mixed] {name}: not refined in f32")
            rhs = W if name != "dia pair slot" else np.concatenate([W, np.zeros_like(W)], axis=1)
            reset_launches()
            got[name] = (solver.solve(torch.as_tensor(rhs, device=dev)),
                         dtype_launches(k1), dtype_launches(k2))
        outs[dev] = got
    for name, (x, l1, l2) in outs[CARD].items():
        rel = rel_diff(x.cpu(), outs["cpu"][name][0])
        log(f"[mixed n={N_SMALL}] refined {name}: card vs CPU rel {rel:.3e}; K1 {l1}, K2 {l2}")
        check(rel <= MIXED_REL_TOL, f"[mixed n={N_SMALL}] refined {name}: card and CPU differ")
        kern = l2 if name == "bell" else l1
        check(kern["f32"] > 0 and kern["f64"] > 0,
              f"[mixed n={N_SMALL}] refined {name}: f32 core or f64 residual not on the kernel")
    runs = {dev: run_gale_mixed(E, A, C, dev, "float32") for dev in (CARD, "cpu")}
    g, c = runs[CARD], runs["cpu"]
    log(f"[mixed n={N_SMALL}] compiled GALE, f32 core: ADI iterations {g['iters']}/{c['iters']}, "
        f"true relative residual {g['true']:.6e}/{c['true']:.6e}, Krylov iterations "
        f"{g['krylov']}/{c['krylov']} in {g['solves']}/{c['solves']} solves; card "
        f"{g['wall']:.3f} s, CPU {c['wall']:.3f} s")
    check(g["iters"] == c["iters"], f"[mixed n={N_SMALL}] GALE: ADI iterations differ")
    check(abs(g["true"] - c["true"]) <= MIXED_RES_TOL * c["true"] and g["true"] <= 1e-10,
          f"[mixed n={N_SMALL}] GALE: residuals differ or miss 1e-10")


def phase_mixed_full(E, A, B, C, dev):
    """The mixed-precision core at full size (phase 15): the compiled GALE
    with the f32 core and with the f64 core; the compiled Newton with f32
    inner solves (at most `MIXED_NEWTON_MAXITERS` steps); one refined
    shifted solve on the block-ELL pencil against the f64 solve.  Returns
    the launches per path, by kernel and dtype."""
    k1_paths, k2_paths = {}, {}
    for sd, key in (("float32", "gale_compiled_f32_core"), (None, "gale_compiled_f64_core")):
        tag = f"[mixed n={N_FULL} gale {key.split('_')[2]} core]"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # this path's run starts here
        out = run_gale_mixed(E, A, C, dev, sd)
        k1_paths[key] = dtype_launches(k1)  # and ends here
        fused_path(key)
        peak = torch.cuda.max_memory_allocated() / 2**30
        X = out["X"]
        log(f"{tag}: wall {out['wall']:.3f} s (set-up {out['setup']:.3f} s: Penzl shifts, "
            f"operators, {out['prec_dtype']} block inverses), ADI iterations {out['iters']}, "
            f"tracked relative residual {out['tracked']:.6e}, true {out['true']:.6e} (JAX "
            f"package at n=1357: 7.35e-11), Krylov iterations {out['krylov']} in "
            f"{out['solves']} solves ({out['krylov'] / max(out['solves'], 1):.1f} a solve), rank "
            f"{X.k}/{X.r}, K1 launches {k1_paths[key]}, peak device memory {peak:.2f} GiB")
        check(all(bool(torch.isfinite(t).all()) for t in (X.L, X.D)), f"{tag}: non-finite X")
        floor = HOST_FLOOR_FACTOR * N_FULL * float(torch.finfo(torch.float64).eps)
        check(np.isfinite(out["true"])
              and abs(out["true"] - out["tracked"]) <= RESIDUAL_AGREE_TOL * out["tracked"] + floor,
              f"{tag}: the true residual {out['true']:.3e} does not confirm the tracked one")
        check(k1_paths[key]["f64"] > 0 and (sd is None or k1_paths[key]["f32"] > 0),
              f"{tag}: K1 was not launched in both dtypes")
        del X, out

    tag = f"[mixed n={N_FULL} newton]"
    prob = newton_problem(E, A, B, C, dev)
    log(f"{tag}: inner_solve_dtype float32, capacity {FGMRES_CAPACITY}, {MIXED_NEWTON_CFG}, "
        f"reltol {NEWTON_RELTOL:g}, {NEWTON_SHIFTS}; at most {MIXED_NEWTON_MAXITERS} "
        f"Newton steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # this path's run starts here
    kry0 = blocklinear.krylov_iterations
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        X, info = solve_gare_newton_compiled(
            prob, shifts=NEWTON_SHIFTS, cfg=MIXED_NEWTON_CFG, capacity=FGMRES_CAPACITY,
            maxiters=MIXED_NEWTON_MAXITERS, reltol=NEWTON_RELTOL, inner_solve_dtype="float32")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_paths["gare_newton_f32_core"] = dtype_launches(k1)  # and ends here
    fused_path("gare_newton_f32_core")
    info["krylov"] = blocklinear.krylov_iterations - kry0
    report_newton(tag, prob, X, info, wall, k1_paths["gare_newton_f32_core"],
                  torch.cuda.max_memory_allocated() / 2**30, N_FULL)
    for text, count in collections.Counter(str(w.message) for w in caught).items():
        log(f"{tag} warning ({count}x): {text}")
    check(k1_paths["gare_newton_f32_core"]["f32"] > 0, f"{tag}: K1 f32 was not launched")
    del X, prob

    tag = f"[mixed n={N_FULL} bell]"
    Eb, Ab = bell_pencil(E, A, bs=BS, dtype=torch.float64, device=dev)
    scale = float(np.mean(np.abs(A.diagonal())) / np.mean(np.abs(E.diagonal())))
    F = shifted_bell(Eb, Ab, -scale)
    del Eb, Ab
    W = torch.as_tensor(np.random.default_rng(16).standard_normal((N_FULL, 7)), device=dev)
    sols = {}
    for name, alg in (("f32 core", MIXED_BELL_KRYLOV),
                      ("f64", dataclasses.replace(MIXED_BELL_KRYLOV, solve_dtype=None))):
        solver = blocklinear.prepare(F, alg)
        torch.cuda.synchronize()
        reset_launches()  # this path's run starts here
        kry0, sol0 = blocklinear.krylov_iterations, blocklinear.krylov_solves
        t0 = time.perf_counter()
        x = solver.solve(W)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2_paths[f"bell_refined_solve_{name.split()[0]}"] = dtype_launches(k2)  # and ends here
        fused_path(f"bell_refined_solve_{name.split()[0]}")
        res = float(torch.linalg.norm(F.mm(x) - W) / torch.linalg.norm(W))
        sols[name] = x
        log(f"{tag} {name}: wall {wall:.3f} s, Krylov iterations "
            f"{blocklinear.krylov_iterations - kry0} in {blocklinear.krylov_solves - sol0} "
            f"solves, relative residual {res:.3e}, K2 launches "
            f"{k2_paths[f'bell_refined_solve_{name.split()[0]}']}")
        check(bool(torch.isfinite(x).all()) and res <= 1e-10, f"{tag} {name}: residual {res:.3e}")
    rel = rel_diff(sols["f32 core"], sols["f64"])
    log(f"{tag}: refined vs f64 solution rel {rel:.3e}")
    check(rel <= MIXED_REL_TOL, f"{tag}: the refined solve differs from the f64 one by {rel:.3e}")
    check(k2_paths["bell_refined_solve_f32"]["f32"] > 0, f"{tag}: K2 f32 was not launched")
    return k1_paths, k2_paths


def by_dtype(launches: dict, paths: dict) -> None:
    """Adds each path's ``{"f64": n, "f32": m}`` to ``launches`` as the
    entries ``"<path>.f64"`` and ``"<path>.f32"``."""
    for path, counts in paths.items():
        for dname, count in counts.items():
            launches[f"{path}.{dname}"] = count


def phase_gmres(E, A, B, C, dev, k1_launches):
    """Phase 14: card vs CPU, then the full-size paths under a
    `ProductLog`.  Adds K1's launches per path and dtype to
    ``k1_launches``; returns the kernels' max abs errors."""
    phase_gmres_small()
    with ProductLog() as products:
        paths = phase_gmres_full(E, A, B, C, dev)
    by_dtype(k1_launches, paths)
    return products.check(f"[gmres n={N_FULL}]")


def phase_mixed(E, A, B, C, dev, k1_launches, k2_launches):
    """Phase 15: card vs CPU, then the full-size paths under a
    `ProductLog`.  Adds K1's and K2's launches per path and dtype; returns
    the kernels' max abs errors."""
    phase_mixed_small()
    with ProductLog() as products:
        paths1, paths2 = phase_mixed_full(E, A, B, C, dev)
    by_dtype(k1_launches, paths1)
    by_dtype(k2_launches, paths2)
    return products.check(f"[mixed n={N_FULL}]")


# --- phase 16: parareal and the row-sharded products -------------------------------


def parareal_problem(E, A, B, C, dev, slabs, n_fine, capacity):
    """`bench.py`'s parareal configuration (its substage at n=1357: τ = 5,
    16 Penzl shifts of ``A − E/(2τ)`` for the fine cores and 16 of
    ``A − E/(2·n_fine·τ)`` for the coarse ones, X0 = lowrank(E⁻¹Cᵀ, 0.01·I),
    `SWEEP_CFG`) at ``slabs × n_fine`` steps.  Returns (problem, fine
    shifts, coarse shifts, shift seconds)."""
    dt = torch.float64
    t0 = time.perf_counter()
    shifts = []
    for tau in (PARAREAL_TAU, n_fine * PARAREAL_TAU):
        sv = heuristic_shifts_host(E, sp.csr_matrix(A - E / (2.0 * tau)), 16, 20, 20)
        check(all(abs(v.imag) <= 1e-12 * abs(v) for v in sv), "Penzl shifts are not real")
        shifts.append(np.asarray([v.real for v in sv]))
    t_shifts = time.perf_counter() - t0
    L0 = spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    X0 = lr_with_capacity(lowrank(torch.as_tensor(L0, dtype=dt, device=dev),
                                  0.01 * torch.eye(C.shape[0], dtype=dt, device=dev)),
                          capacity)
    E_op, A_op = dia_pencil(E, A, dtype=dt, device=dev)
    prob = GDREProblem(E_op, A_op, torch.as_tensor(B, dtype=dt, device=dev),
                       torch.as_tensor(C, dtype=dt, device=dev), X0,
                       (4500.0, 4500.0 - slabs * n_fine * PARAREAL_TAU))
    return prob, shifts[0], shifts[1], t_shifts


def run_parareal(prob, shifts, cshifts, capacity, alg, mesh=None):
    """`solve_gdre_parareal` with a synchronized wall; (solution, wall)."""
    sync = prob.B.device.type == "cuda"
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve_gdre_parareal(prob, dt=-PARAREAL_TAU, shifts=shifts, coarse_shifts=cshifts,
                              cfg=SWEEP_CFG, capacity=capacity, alg=alg, mesh=mesh)
    if sync:
        torch.cuda.synchronize()
    return sol, time.perf_counter() - t0


def run_serial(prob, shifts, capacity):
    """The serial `solve_gdre_ros1_compiled` on the fine shifts; (solution,
    wall)."""
    sync = prob.B.device.type == "cuda"
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve_gdre_ros1_compiled(prob, dt=-PARAREAL_TAU, shifts=shifts, cfg=SWEEP_CFG,
                                   capacity=capacity)
    if sync:
        torch.cuda.synchronize()
    return sol, time.perf_counter() - t0


def lr_cpu(X: LowRank) -> LowRank:
    return LowRank(L=X.L.cpu(), D=X.D.cpu(), k=X.k)


def worst_K(sol, ref) -> float:
    return max(rel_diff(a.cpu(), b.cpu()) for a, b in zip(sol.K[1:], ref.K[1:]))


def parareal_counts(sol):
    info = sol.parareal_info
    return (info["iterations"], info["stopped_by"], sol.adi_iters, info["fine_iters_total"])


def phase_parareal_small():
    """Phase 16a: parareal at n=1357 (S = 4, n_fine = 2, max_iters = 4,
    capacity `SMALL_CAPACITY`) on the card and on the CPU, each against its
    serial sweep (classical exactness, `PARAREAL_EXACT_TOL`); card vs CPU in
    every K and boundary (`STEP_REL_TOL`) with equal counts; then the same
    solve over a world-size-1 NCCL group (`make_mesh(1)`) against the run
    without a group (`PARAREAL_MESH_TOL`)."""
    E, A, B, C = rail_surrogate(N_SMALL)
    alg = Parareal(slabs=4, max_iters=4)
    outs = {}
    for dev in (CARD, "cpu"):
        prob, shifts, cshifts, _ = parareal_problem(E, A, B, C, dev, 4, 2, SMALL_CAPACITY)
        sol, wall = run_parareal(prob, shifts, cshifts, SMALL_CAPACITY, alg)
        ser, swall = run_serial(prob, shifts, SMALL_CAPACITY)
        dK = worst_K(sol, ser)
        dX = lr_rel_diff(sol.X[-1], ser.X[-1])
        log(f"[parareal n={N_SMALL}] {dev}: {wall:.3f} s (serial {swall:.3f} s), "
            f"iterations {sol.parareal_info['iterations']} ({sol.parareal_info['stopped_by']}), "
            f"deltas {['%.3e' % d for d in sol.parareal_info['deltas']]}, ADI iters "
            f"{sol.adi_iters} (all sweeps {sol.parareal_info['fine_iters_total']}); "
            f"vs serial: K {dK:.3e}, X(T) {dX:.3e}")
        check(dK <= PARAREAL_EXACT_TOL and dX <= PARAREAL_EXACT_TOL,
              f"parareal n={N_SMALL} {dev}: not the serial sweep (K {dK:.3e}, X {dX:.3e})")
        outs[dev] = (sol, prob, shifts, cshifts)
    (g, prob, shifts, cshifts), (c, _, _, _) = outs[CARD], outs["cpu"]
    dK = worst_K(g, c)
    dB = max(lr_rel_diff(lr_cpu(a), b) for a, b in zip(g.X, c.X))
    log(f"[parareal n={N_SMALL}] card vs CPU: K {dK:.3e}, boundaries {dB:.3e}, counts "
        f"{parareal_counts(g)} / {parareal_counts(c)}")
    check(parareal_counts(g) == parareal_counts(c),
          f"parareal n={N_SMALL}: counts differ (card {parareal_counts(g)}, "
          f"CPU {parareal_counts(c)})")
    check(dK <= STEP_REL_TOL and dB <= STEP_REL_TOL,
          f"parareal n={N_SMALL}: card and CPU differ beyond {STEP_REL_TOL}")

    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, axis="slab")
        m, wall = run_parareal(prob, shifts, cshifts, SMALL_CAPACITY, alg, mesh=mesh)
    finally:
        dist.destroy_process_group()
    dK = worst_K(m, g)
    dB = max(lr_rel_diff(a, b) for a, b in zip(m.X, g.X))
    log(f"[parareal n={N_SMALL}] over a world-size-1 NCCL mesh: {wall:.3f} s, K {dK:.3e}, "
        f"boundaries {dB:.3e} from the run without a group")
    check(parareal_counts(m) == parareal_counts(g) and dK <= PARAREAL_MESH_TOL
          and dB <= PARAREAL_MESH_TOL,
          f"parareal n={N_SMALL}: the NCCL mesh run differs (K {dK:.3e}, X {dB:.3e})")


def phase_parareal_full(E, A, B, C, dev):
    """Phase 16b: parareal at n=79841 on the DIA pencil (S = 8, n_fine = 4,
    32 steps, capacity `CAPACITY`, `Parareal(8, max_iters=2)`) through K1,
    beside the serial 32-step sweep on the same fine shifts.  Returns the
    K1 launches of the parareal run."""
    tag = f"[parareal n={N_FULL}]"
    prob, shifts, cshifts, t_shifts = parareal_problem(E, A, B, C, dev, 8, 4, CAPACITY)
    log(f"{tag} Penzl shifts (fine and coarse) in {t_shifts:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the main path's run starts here
    sol, wall = run_parareal(prob, shifts, cshifts, CAPACITY, Parareal(slabs=8, max_iters=2))
    launches = k1.launches  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    ser, swall = run_serial(prob, shifts, CAPACITY)
    info = sol.parareal_info
    d = info["deltas"]
    dK = rel_diff(sol.K[-1].cpu(), ser.K[-1].cpu())
    finite = all(bool(torch.isfinite(K).all()) for K in sol.K) and all(
        bool(torch.isfinite(X.L).all() and torch.isfinite(X.D).all()) for X in sol.X)
    log(f"{tag} parareal wall {wall:.3f} s ({info['iterations']} iterations, "
        f"{info['stopped_by']}), serial wall {swall:.3f} s; deltas "
        f"{['%.6e' % v for v in d]}; ADI iterations: final sweep {sol.adi_iters}, all "
        f"sweeps {info['fine_iters_total']} (serial {ser.adi_iters}); worst res "
        f"{info['res_max_all_sweeps']:.3e}; ‖K_par(T) − K_ser(T)‖/‖K_ser(T)‖ {dK:.3e}; "
        f"peak {peak:.2f} GiB; K1 launches {launches}")
    check(finite, f"{tag}: non-finite output")
    check(len(d) < 2 or d[1] < d[0], f"{tag}: deltas do not contract: {d}")
    check(launches > 0, f"{tag}: K1 was not launched")
    return launches


def phase_sharded_products(E, A, dev):
    """Phase 16c: the row-sharded DIA and block-ELL (bs = 128) products at
    n=79841 on one card, emulated: `SHARDS` row shards
    (`shard_operator(..., rank=r)`), each fed the halo-extended operand the
    exchange would deliver, sliced from the whole X; each shard's local
    product through K1 or K2, concatenated; ``mm`` and ``tmm`` at q = 48
    against the unsharded product and the plain version (`REL_TOL`).
    Returns ({path: K1 launches}, {path: K2 launches}, K1 and K2 max abs
    errors)."""
    tag = f"[sharded n={N_FULL}]"
    gen = torch.Generator(device=CARD).manual_seed(16)
    X = torch.randn((N_FULL, 48), generator=gen, dtype=torch.float64, device=dev)
    _, A_dia = dia_pencil(E, A, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    A_bell = bell_from_scipy(A, bs=BS, dtype=torch.float64, device=dev)
    shards = {"dia": [shard_operator(None, A_dia, rank=r, world=SHARDS) for r in range(SHARDS)],
              "bell": [shard_operator(None, A_bell, rank=r, world=SHARDS)
                       for r in range(SHARDS)]}
    torch.cuda.synchronize()
    log(f"{tag} {SHARDS} shards built in {time.perf_counter() - t0:.2f} s: DIA rows "
        f"{[s.rows for s in shards['dia']]}, halo {shards['dia'][0].H}; block-ELL rows "
        f"{[s.rows for s in shards['bell']]}, halo {shards['bell'][0].H} block rows")

    outs, paths = {}, {}
    for fmt, kern in (("dia", k1), ("bell", k2)):
        reset_launches()  # this path's run starts here
        for t in (False, True):
            outs[(fmt, t)] = torch.cat([s.local_mm(s.extend(X), t=t) for s in shards[fmt]])
        torch.cuda.synchronize()
        paths[fmt] = kern.launches  # ... and ends here
    errs = {}
    for (fmt, t), Y in outs.items():
        op = A_dia if fmt == "dia" else A_bell
        full = op.tmm(X) if t else op.mm(X)
        if fmt == "dia":
            offs = tuple(-o for o in op.offsets) if t else op.offsets
            plain = k1.dia_mm_plain(op.data_t if t else op.data, offs, X)
        else:
            plain = k2.bell_mm_plain(op.cols_t if t else op.cols, op.data_t if t else op.data, X)
        name = f"{tag} {fmt} {'tmm' if t else 'mm'}"
        e1, r1 = check_close(f"{name} vs unsharded", Y, full, "float64")
        e2, r2 = check_close(f"{name} vs plain", Y, plain, "float64")
        errs[fmt] = max(errs.get(fmt, 0.0), e1, e2)
        log(f"{name}: {SHARDS} shards = unsharded (rel {r1:.3e}) = plain (rel {r2:.3e})")
    for fmt in ("dia", "bell"):
        check(paths[fmt] == 2 * SHARDS, f"{tag} {fmt}: {paths[fmt]} launches, "
                                        f"not {2 * SHARDS}")
    log(f"{tag} launches: K1 {paths['dia']}, K2 {paths['bell']}")
    return ({"sharded_dia": paths["dia"]}, {"sharded_bell": paths["bell"]},
            errs["dia"], errs["bell"])


def phase_parareal(E, A, B, C, dev, k1_launches, k2_launches):
    """Phase 16: 16a, then 16b under a `ProductLog`, then 16c.  Adds the
    launches per path to ``k1_launches`` and ``k2_launches``; returns the
    kernels' max abs errors."""
    phase_parareal_small()
    launches, err1 = checked(f"[parareal n={N_FULL}]", "K1",
                             lambda: phase_parareal_full(E, A, B, C, dev))
    k1_launches["parareal"] = launches
    l1, l2, e1, e2 = phase_sharded_products(E, A, dev)
    k1_launches.update(l1)
    k2_launches.update(l2)
    return {"K1": max(err1, e1), "K2": e2}


def with_peak(run):
    """``run()`` and the peak device memory (GiB) it allocated above what
    was allocated when it started."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def collective_costs(mesh, op):
    """Host µs per call (`COLLECTIVE_CALLS` calls, ending in a
    synchronize) of a Krylov dot on a ``(14, nl)`` lane-major pair state,
    of its all-reduce (`mesh.row_allreduce` of a scalar) and of one halo
    exchange of that state, on ``mesh``."""
    gen = torch.Generator(device=CARD).manual_seed(17)
    Xt = torch.randn((14, op.N), generator=gen, dtype=torch.float64, device=CARD)
    s = blocklinear._vdot(Xt, Xt)
    calls = {"dot": lambda: blocklinear._vdot(Xt, Xt),
             "all_reduce": lambda: mesh_mod.row_allreduce(s),
             "halo_exchange": lambda: sharded_ops.halo_exchange(Xt, op.H, mesh, dim=1)}
    costs = {}
    with mesh_mod.use_mesh(mesh):
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(COLLECTIVE_CALLS):
                call()
            torch.cuda.synchronize()
            costs[name] = (time.perf_counter() - t0) * 1e6 / COLLECTIVE_CALLS
    return costs


def newton_step_run(E_op, A_op, B_d, C_d, X0, mesh=None):
    """17a's Newton step on phase 3's operands (split over ``mesh`` if
    given): (X, K at X gathered, ADI iterations, wall, K1 launches, Krylov
    iterations, collectives)."""
    G = lr_with_capacity(lowrank(B_d), 16)
    Q = lr_with_capacity(lowrank(C_d.T.contiguous()), 16)
    shifts = FULL_STEP_BUFFERS["real"]
    if mesh is not None:
        E_op, A_op, B_d, C_d = dryrun.shard_pencil(mesh, E_op, A_op, B_d, C_d)
        X0, G, Q = (shard_lowrank(mesh, Y, PREC_BS) for Y in (X0, G, Q))
    lus = build_dia_shift_ops(E_op, A_op, shifts)
    l0, s0 = k1.launches, blocklinear.krylov_iterations
    c0 = collections.Counter(mesh_mod.collectives)
    torch.cuda.synchronize()
    t = time.perf_counter()
    K0 = feedback_K(E_op, B_d, X0)
    res = residual_gare_lowrank(E_op, A_op, G, Q, X0, r_out=FULL_STEP_CFG.r_res)
    X, iters, _ = _newton_step_compiled(E_op, A_op, B_d, X0, K0, res, shifts,
                                        FULL_STEP_ABSTOL, FULL_STEP_CFG, lus)
    K = feedback_K(E_op, B_d, X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    X, K = dryrun.gather_state(mesh, X, K, E_op.n)
    return (X, K, iters, wall, k1.launches - l0, blocklinear.krylov_iterations - s0,
            dict(mesh_mod.collectives - c0))


def hold_twins(tag, counts, diffs):
    """``counts``: {name: (sharded, unsharded)}, equal but for ``Krylov``
    iterations (within `KRYLOV_REL_TOL`); ``diffs``: {name: relative
    difference}, each within `SHARDED_TOL`."""
    log(f"{tag}: sharded vs unsharded: "
        + ", ".join(f"{k} {a} / {b}" for k, (a, b) in counts.items()) + "; "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()))
    for name, (a, b) in counts.items():
        same = abs(a - b) <= KRYLOV_REL_TOL * b if name == "Krylov" else a == b
        check(same, f"{tag}: {name} {a} sharded, {b} unsharded")
    check(all(v <= SHARDED_TOL for v in diffs.values()), f"{tag}: {diffs} beyond {SHARDED_TOL}")


def phase_sharded_steps_card(E, A, B, C, dev):
    """Phase 17a: phase 3's 4 Ros1 steps and 17a's Newton step at n=79841,
    without a group, then on row shards (`shard_operator(...,
    block=PREC_BS)`) over a world-size-1 NCCL group, each sharded run under
    a `ProductLog`.  One card has no neighbour: the halo exchanges send
    nothing, and the all-reduces reduce one rank.  Returns ({path: K1
    launches}, K1 max abs error)."""
    tag = f"[sharded steps n={N_FULL}]"
    inputs = full_step_inputs(E, A, B, C, dev)
    peaks = {}
    (_, ref_rows), peaks["ros1"] = with_peak(
        lambda: run_full_steps(*inputs, step_ops(*inputs[:2])))
    ref_newton, peaks["newton"] = with_peak(lambda: newton_step_run(*inputs))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, timeout=GROUP_TIMEOUT)
    out, launches, err = {}, {}, 0.0
    try:
        mesh = make_mesh(1)
        E_s, A_s, B_s, C_s = dryrun.shard_pencil(mesh, *inputs[:4])
        X0_s = shard_lowrank(mesh, inputs[4], PREC_BS)
        ops = step_ops(E_s, A_s)

        def ros1():
            k1.launches = 0  # this path's run starts here
            (_, out["ros1"]), out["ros1_peak"] = with_peak(
                lambda: run_full_steps(E_s, A_s, B_s, C_s, X0_s, ops))
            return k1.launches  # ... and ends here

        def newton():
            k1.launches = 0  # this path's run starts here
            out["newton"], out["newton_peak"] = with_peak(
                lambda: newton_step_run(*inputs, mesh=mesh))
            return k1.launches  # ... and ends here

        for name, run in (("sharded_ros1", ros1), ("sharded_newton", newton)):
            launches[name], e = checked(f"{tag} {name}", "K1", run)
            err = max(err, e)
        gathered = [dryrun.gather_state(mesh, row[4], row[5], E_s.n) for row in out["ros1"]]
        costs = collective_costs(mesh, E_s)
    finally:
        dist.destroy_process_group()
    log(f"{tag} 1 rank over NCCL: the halo exchanges have no neighbour and send "
        "nothing; no cross-card traffic is measured")
    for j, (row, ref, (X, K)) in enumerate(zip(out["ros1"], ref_rows, gathered)):
        name, wall, iters, res, _, _, nl, ns, coll = row
        log(f"{tag} Ros1 step {j + 1} ({name} buffer): wall {wall:.3f} s sharded, "
            f"{ref[1]:.3f} s unsharded; ADI iters {iters}, res {res:.6e}; K1 launches {nl} "
            f"(unsharded {ref[6]}); collectives {coll}")
        hold_twins(f"{tag} Ros1 step {j + 1}", {"ADI": (iters, ref[2]), "Krylov": (ns, ref[7])},
                   {"LDLᵀ": lr_rel_diff(X, ref[4]), "K": rel_diff(K, ref[5])})
    X, K, iters, wall, nl, ns, coll = out["newton"]
    log(f"{tag} Newton step: wall {wall:.3f} s sharded, {ref_newton[3]:.3f} s unsharded; "
        f"ADI iters {iters}; K1 launches {nl} (unsharded {ref_newton[4]}); collectives {coll}")
    hold_twins(f"{tag} Newton step", {"ADI": (iters, ref_newton[2]), "Krylov": (ns, ref_newton[5])},
               {"LDLᵀ": lr_rel_diff(X, ref_newton[0]), "K": rel_diff(K, ref_newton[1])})
    log(f"{tag} peak device memory above the run's start, sharded (unsharded): Ros1 "
        f"steps {out['ros1_peak']:.3f} ({peaks['ros1']:.3f}) GiB, Newton step "
        f"{out['newton_peak']:.3f} ({peaks['newton']:.3f}) GiB; K1 launches {launches}")
    log(f"{tag} host µs per call, {COLLECTIVE_CALLS} calls ending in a synchronize: "
        + ", ".join(f"{k} {v:.1f}" for k, v in costs.items()) + f"; {card_line()}")
    for name, n_launch in launches.items():
        check(n_launch > 0, f"{tag} {name}: K1 was not launched")
    return launches, err


def sweep_rank(dev, n):
    """Phase 17b's rank: `dryrun.ros1_sweep` at ``n`` over the group's
    ranks; the gathered LDLᵀ and Ks as numpy arrays, the counts."""
    X, Ks, adi, kry = dryrun.ros1_sweep(dev, n, make_mesh(device=dev.type))
    return (X.L @ X.D @ X.L.T).numpy(), [K.numpy() for K in Ks], adi, kry


def phase_sharded_sweep_cpu():
    """Phase 17b: the JAX test's Ros1 sweep at n=1357 over
    `SHARDED_CPU_RANKS` gloo ranks on the host's CPU (NCCL puts no two ranks
    on one GPU) against one process: equal ADI iterations, Krylov
    iterations within `KRYLOV_REL_TOL`, every K and the final LDLᵀ within
    `SHARDED_TOL`."""
    tag = f"[sharded sweep n={N_SHARDED_CPU}, {SHARDED_CPU_RANKS} gloo ranks]"
    t0 = time.perf_counter()
    X, Ks, adi, kry = dryrun.run_ranks(sweep_rank, SHARDED_CPU_RANKS, "cpu",
                                       args=(N_SHARDED_CPU,))
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xr, Ksr, adir, kryr = dryrun.ros1_sweep(torch.device("cpu"), N_SHARDED_CPU)
    wall_ref = time.perf_counter() - t0
    dX = rel_diff(torch.as_tensor(X), Xr.L @ Xr.D @ Xr.L.T)
    dK = max(rel_diff(torch.as_tensor(a), b) for a, b in zip(Ks, Ksr))
    log(f"{tag}: {wall:.3f} s (spawn included), one process {wall_ref:.3f} s; ADI {adi} / "
        f"{adir}, Krylov {kry} / {kryr}; LDLᵀ {dX:.3e}, worst K {dK:.3e}")
    check(adi == adir and len(Ks) == len(Ksr), f"{tag}: ADI iterations differ ({adi}, {adir})")
    check(abs(kry - kryr) <= KRYLOV_REL_TOL * kryr, f"{tag}: Krylov {kry} vs {kryr}")
    check(dX <= SHARDED_TOL and dK <= SHARDED_TOL,
          f"{tag}: LDLᵀ {dX:.3e}, K {dK:.3e} beyond {SHARDED_TOL}")


def phase_sharded(E, A, B, C, dev, k1_launches):
    """Phase 17: 17a on the card, then 17b on the host's CPU.  Adds the
    launches per path to ``k1_launches``; returns K1's max abs error."""
    t0 = time.perf_counter()
    launches, err = phase_sharded_steps_card(E, A, B, C, dev)
    k1_launches.update(launches)
    phase_sharded_sweep_cpu()
    log(f"[sharded] phase 17 took {time.perf_counter() - t0:.1f} s")
    return err


# --- phase 18: block-ELL shards, Ros2 on shards, the f32 core and GMRES over a mesh ------


class StepMarks:
    """A sweep's ``observer``: at each stop the wall since the last one
    (synchronized), ADI iterations, residual, K2 launches, Krylov iterations
    and collectives (`mesh.collectives`) since the last one."""

    def __init__(self):
        self.rows = []
        self._mark()

    def _mark(self):
        torch.cuda.synchronize()
        self.t, self.k2, self.kry = time.perf_counter(), k2.launches, blocklinear.krylov_iterations
        self.coll = collections.Counter(mesh_mod.collectives)

    def __call__(self, i, X, K, iters, res):
        torch.cuda.synchronize()
        self.rows.append((i, time.perf_counter() - self.t, iters,
                          None if res is None else float(res), k2.launches - self.k2,
                          blocklinear.krylov_iterations - self.kry,
                          dict(mesh_mod.collectives - self.coll)))
        self._mark()


def run_twins(tag, run, mesh):
    """``run(None)``, then ``run(mesh)``: each a main path whose launches
    are counted from 0 (reset just before it, read just after it), and
    whose products are held to the plain versions after it (`ProductLog`).
    The unsharded run takes the CG loop a mesh takes (`unfused`), so the
    twins share their roundings (phase 20 holds the fused iteration to it).
    Returns ({"unsharded"/"sharded": (result, K1 and K2 launches by
    dtype)}, {kernel: max abs error})."""
    outs, errs = {}, {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        with ProductLog() as products, (unfused() if m is None else contextlib.nullcontext()):
            reset_launches()  # this path's run starts here
            out = run(m)
            torch.cuda.synchronize()
            outs[name] = (out, dtype_launches(k1), dtype_launches(k2))  # ... and ends here
        for kern, err in products.check(f"{tag} {name}").items():
            errs[kern] = max(errs.get(kern, 0.0), err)
    return outs, errs


def phase_shards_bell(E, A, B, C, dev, mesh):
    """Phase 18a: phase 5's block-ELL Ros2 sweep at n=79841 (bs = 128, 16
    Penzl shifts, capacity 96, 5 steps), without a group, then on block-ELL
    row shards over ``mesh``; the unsharded run's shifted operators are
    freed before the sharded run builds its own.  Returns (K2 launches of
    the sharded run, max abs errors, the block-ELL pencil)."""
    tag = f"[shards bell n={N_FULL}]"
    t0 = time.perf_counter()
    E_b = bell_pencil(E, A, bs=BS, dtype=torch.float64, device=dev)
    shifts = dryrun.sweep_shifts(E, A, "ros2", TAU, 16)
    X0 = dryrun.rail_x0(E, C, dev, CAPACITY)
    B_d, C_d = (torch.as_tensor(M, dtype=torch.float64, device=dev) for M in (B, C))
    torch.cuda.synchronize()
    log(f"{tag} pencil, 16 Penzl shifts of (E, γτA − E/2) and X0 in "
        f"{time.perf_counter() - t0:.2f} s")

    def run(m):
        marks = StepMarks()
        t = time.perf_counter()
        out, peak = with_peak(lambda: dryrun.run_sweep(
            "ros2", *E_b, B_d, C_d, X0, shifts, m, tau=TAU, nsteps=FULL_STEPS, cfg=SWEEP_CFG,
            capacity=CAPACITY, observer=marks))
        return out, peak, marks.rows, time.perf_counter() - t

    outs, errs = run_twins(tag, run, mesh)
    (ref, peak_r, rows_r, wall_r), _, l2_r = outs["unsharded"]
    (got, peak, rows, wall), _, l2 = outs["sharded"]
    for (i, w, it, res, nl, kry, coll), (_, w_r, it_r, _, nl_r, kry_r, _) in zip(rows, rows_r):
        what = "set-up (shards, shifted operators, block inverses)" if i == 0 else f"step {i}"
        log(f"{tag} {what}: wall {w:.3f} s sharded, {w_r:.3f} s unsharded; ADI {it} / {it_r}, "
            f"res {res}; K2 launches {nl} / {nl_r}; Krylov {kry} / {kry_r}; collectives {coll}")
        check(it == it_r and nl == nl_r, f"{tag} {what}: ADI iterations or K2 launches differ")
    dX = lr_rel_diff(got[0], ref[0])
    dK = max(rel_diff(a, b) for a, b in zip(got[1], ref[1]))
    hold_twins(tag, {"ADI": (got[2], ref[2]), "Krylov": (got[3], ref[3])},
               {"LDLᵀ": dX, "worst K": dK})
    log(f"{tag} {FULL_STEPS} steps: wall {wall:.3f} s sharded, {wall_r:.3f} s unsharded; K2 "
        f"launches {l2['f64']} / {l2_r['f64']}; peak device memory above the run's start "
        f"{peak:.3f} / {peak_r:.3f} GiB; {card_line()}")
    check(l2["f64"] > 0 and l2 == l2_r, f"{tag}: K2 launches {l2} sharded, {l2_r} unsharded")
    check(all(bool(torch.isfinite(K).all()) for K in got[1]), f"{tag}: non-finite K")
    return l2["f64"], errs, E_b


def ros2_steps_run(E_op, A_op, B_d, C_d, X0, mesh=None):
    """Phase 18b's two Ros2 steps from phase 3's X0 (the pair buffer, then
    the real one; τ = 10, `FULL_STEP_CFG`), on DIA row shards over ``mesh``
    if given: rows (buffer, wall, ADI iterations, residual, X, K gathered,
    Krylov iterations, collectives)."""
    if mesh is not None:
        E_op, A_op, B_d, C_d = dryrun.shard_pencil(mesh, E_op, A_op, B_d, C_d)
        X0 = shard_lowrank(mesh, X0, PREC_BS)
    F_core = lin_comb(scale_op(A_op, _ROS2_GAMMA * FULL_STEP_TAU), -0.5, E_op)
    cache = {}
    ops = {name: build_dia_shift_ops(E_op, F_core, FULL_STEP_BUFFERS[name], block_cache=cache)
           for name in ("pair", "real")}
    rows, X = [], X0
    for name in ("pair", "real"):
        s0, c0 = blocklinear.krylov_iterations, collections.Counter(mesh_mod.collectives)
        torch.cuda.synchronize()
        t = time.perf_counter()
        X, K, iters, res = ros2_step_compiled(E_op, A_op, B_d, C_d, X, FULL_STEP_TAU,
                                              FULL_STEP_BUFFERS[name], FULL_STEP_ABSTOL,
                                              FULL_STEP_CFG, ops[name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rows.append((name, wall, iters, float(res), *dryrun.gather_state(mesh, X, K, E_op.n),
                     blocklinear.krylov_iterations - s0, dict(mesh_mod.collectives - c0)))
    return rows


def phase_shards_dia(E, A, B, C, dev, mesh, E_b):
    """Phases 18b–d on the card, each without a group, then on row shards
    over ``mesh``: 18b two Ros2 steps on DIA shards (phase 3's inputs); 18c
    phase 15's compiled GALE with the f32 core on DIA shards and one refined
    block-ELL solve (phase 15's) on block-ELL shards of ``E_b``; 18d
    `GMRES_KRYLOV` on Aᵀ − Eᵀ in DIA.  Returns ({path: K1 launches}, {path:
    K2 launches}, max abs errors)."""
    inputs = full_step_inputs(E, A, B, C, dev)
    l1, l2, errs = {}, {}, {}

    def merge(e):
        for kern, err in e.items():
            errs[kern] = max(errs.get(kern, 0.0), err)

    tag = f"[shards dia ros2 n={N_FULL}]"
    outs, e = run_twins(tag, lambda m: ros2_steps_run(*inputs, mesh=m), mesh)
    merge(e)
    (rows, k1s, _), (rows_r, k1_r, _) = outs["sharded"], outs["unsharded"]
    for row, ref in zip(rows, rows_r):
        name, wall, iters, res, X, K, kry, coll = row
        log(f"{tag} Ros2 step ({name} buffer): wall {wall:.3f} s sharded, {ref[1]:.3f} s "
            f"unsharded; ADI {iters}, res {res:.6e}; collectives {coll}")
        hold_twins(f"{tag} {name} step", {"ADI": (iters, ref[2]), "Krylov": (kry, ref[6])},
                   {"LDLᵀ": lr_rel_diff(X, ref[4]), "K": rel_diff(K, ref[5])})
    log(f"{tag} K1 launches {k1s} sharded, {k1_r} unsharded")
    check(k1s["f64"] > 0 and k1s == k1_r, f"{tag}: K1 launches {k1s}, {k1_r}")
    l1["sharded_dia_ros2"] = k1s["f64"]

    tag = f"[shards gale f32 core n={N_FULL}]"
    outs, e = run_twins(tag, lambda m: run_gale_mixed(E, A, C, dev, "float32", mesh=m), mesh)
    merge(e)
    (g, k1s, _), (r, k1_r, _) = outs["sharded"], outs["unsharded"]
    log(f"{tag}: wall {g['wall']:.3f} s sharded, {r['wall']:.3f} s unsharded; true relative "
        f"residual {g['true']:.6e} / {r['true']:.6e}; K1 launches {k1s} / {k1_r}")
    hold_twins(tag, {"ADI": (g["iters"], r["iters"]), "Krylov": (g["krylov"], r["krylov"])},
               {"LDLᵀ": lr_rel_diff(g["X"], r["X"]),
                "residual": abs(g["true"] - r["true"]) / r["true"]})
    check(k1s["f32"] > 0 and k1s == k1_r, f"{tag}: K1 launches {k1s}, {k1_r}")
    by_dtype(l1, {"sharded_gale_f32_core": k1s})

    scale = float(np.mean(np.abs(A.diagonal())) / np.mean(np.abs(E.diagonal())))
    W = torch.as_tensor(np.random.default_rng(16).standard_normal((E.shape[0], 7)), device=dev)
    for tag, key, op, alg, kern in (
            (f"[shards bell refined n={N_FULL}]", "sharded_bell_refined",
             shifted_bell(*E_b, -scale), MIXED_BELL_KRYLOV, 1),
            (f"[shards gmres n={N_FULL}]", "sharded_gmres",
             shifted_dia(*inputs[:2], -1.0), GMRES_KRYLOV, 0)):
        def solve(m, op=op, alg=alg):
            t = time.perf_counter()
            x, kry = dryrun.solve_sharded(m, op, W, alg)
            return x, kry, time.perf_counter() - t

        outs, e = run_twins(tag, solve, mesh)
        merge(e)
        (x, kry, wall), *ls = outs["sharded"]
        (x_r, kry_r, wall_r), *ls_r = outs["unsharded"]
        res = float(torch.linalg.norm(op.mm(x) - W) / torch.linalg.norm(W))
        log(f"{tag}: wall {wall:.3f} s sharded, {wall_r:.3f} s unsharded; relative residual "
            f"{res:.3e}; {'K2' if kern else 'K1'} launches {ls[kern]} / {ls_r[kern]}")
        hold_twins(tag, {"Krylov": (kry, kry_r)}, {"solution": rel_diff(x, x_r)})
        check(res <= 1e-10 and ls == ls_r, f"{tag}: residual {res:.3e}, launches {ls}, {ls_r}")
        check(alg.solve_dtype is None or ls[kern]["f32"] > 0, f"{tag}: no f32 launch")
        if kern:
            by_dtype(l2, {key: ls[kern]})
        else:
            l1[key] = ls[kern]["f64"]
    return l1, l2, errs


def small_factor(n, seed=18):
    """An ``(n, 48)`` f64 factor with 40 active columns and a symmetric
    indefinite inner factor (18e's `gram` compression)."""
    rng = np.random.default_rng(seed)
    L, D = np.zeros((n, 48)), np.zeros((48, 48))
    L[:, :40] = rng.standard_normal((n, 40))
    S = rng.standard_normal((40, 40))
    D[:40, :40] = S + S.T
    return lowrank(torch.as_tensor(L), torch.as_tensor(D), k=40)


def shards_runs(dev, n, mesh=None):
    """Phase 18e's runs at ``n`` on ``dev``, split over ``mesh`` if given:
    the block-ELL Ros2 sweep (phase 4's configuration: bs = 128, 16 Penzl
    shifts, capacity 160, 3 steps), a `gram` compression and the
    `GMRES_KRYLOV` solve of Aᵀ − Eᵀ (DIA).  Returns numpy results."""
    X, Ks, adi, kry = dryrun.bell_sweep(
        dev, n, mesh, "ros2", bs=BS, nsteps=SMALL_STEPS, capacity=SMALL_CAPACITY,
        cfg=dataclasses.astuple(SWEEP_CFG), nshifts=16)
    Y = dryrun.compress_sharded(mesh, small_factor(n))
    E, A, _, _ = rail_surrogate(n)
    W = torch.as_tensor(np.random.default_rng(14).standard_normal((n, 7)))
    x, kry_g = dryrun.solve_sharded(mesh, shifted_dia(*dia_pencil(E, A, device=dev), -1.0),
                                    W, GMRES_KRYLOV)
    dense = lambda Z: (Z.L @ Z.D @ Z.L.T).numpy()  # noqa: E731
    return (dense(X), [K.numpy() for K in Ks], adi, kry, dense(Y), Y.k, x.numpy(), kry_g)


def shards_rank(dev, n):
    """Phase 18e's rank: `shards_runs` over the group's ranks."""
    return shards_runs(dev, n, make_mesh(device=dev.type))


def phase_shards_cpu():
    """Phase 18e: `shards_runs` at n=1357 over `SHARDED_CPU_RANKS` gloo
    ranks on the host's CPU (11 block rows split 3/3/3/2, a halo of 1 block
    row) against one process: equal ADI and Krylov counts (within
    `KRYLOV_REL_TOL`), every K, the LDLᵀs and the GMRES solution within
    `SHARDED_TOL`."""
    tag = f"[shards n={N_SHARDED_CPU}, {SHARDED_CPU_RANKS} gloo ranks]"

    def timed(fn, *args):
        t = time.perf_counter()
        return fn(*args), time.perf_counter() - t

    # The ranks mostly wait on their collectives: the one-process runs go
    # meanwhile.
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(timed, dryrun.run_ranks, shards_rank, SHARDED_CPU_RANKS, "cpu",
                            (N_SHARDED_CPU,))
        ref, wall_ref = timed(shards_runs, torch.device("cpu"), N_SHARDED_CPU)
        got, wall = ranks.result()
    X, Ks, adi, kry, Y, k, x, kry_g = got
    Xr, Ksr, adir, kryr, Yr, kr, xr, kry_gr = ref
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    log(f"{tag}: {wall:.3f} s (spawn included), one process {wall_ref:.3f} s, both at once")
    hold_twins(f"{tag} block-ELL Ros2 sweep", {"ADI": (adi, adir), "Krylov": (kry, kryr)},
               {"LDLᵀ": rel(X, Xr), "worst K": max(rel(a, b) for a, b in zip(Ks, Ksr))})
    hold_twins(f"{tag} gram compression", {"rank": (k, kr)}, {"LDLᵀ": rel(Y, Yr)})
    hold_twins(f"{tag} GMRES", {"Krylov": (kry_g, kry_gr)}, {"solution": rel(x, xr)})


def phase_shards(E, A, B, C, dev, k1_launches, k2_launches):
    """Phase 18: 18a–d on the card over a world-size-1 NCCL group, then
    18e on the host's CPU.  Adds the launches per path to ``k1_launches``
    and ``k2_launches``; returns the kernels' max abs errors."""
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, timeout=GROUP_TIMEOUT)
    try:
        mesh = make_mesh(1)
        launches, errs, E_b = phase_shards_bell(E, A, B, C, dev, mesh)
        k2_launches["sharded_bell_ros2"] = launches
        l1, l2, e = phase_shards_dia(E, A, B, C, dev, mesh, E_b)
        del E_b
        k1_launches.update(l1)
        k2_launches.update(l2)
        for kern, err in e.items():
            errs[kern] = max(errs.get(kern, 0.0), err)
    finally:
        dist.destroy_process_group()
    log("[shards] 1 rank over NCCL: the halo exchanges have no neighbour and send nothing")
    phase_shards_cpu()
    log(f"[shards] phase 18 took {time.perf_counter() - t0:.1f} s; {card_line()}")
    return errs


# --- phase 19: the uncached route, complex banded cores, the full Newton on row shards --

# 19a: phase 3's first Ros1 step (FULL_STEP_CFG, τ = 10, capacity 96, X0 =
# lowrank(E⁻¹Cᵀ, 0.01·I)) with the 1-D complex buffer SHIFTS, once without
# cores (the uncached route: a solver prepared for each ADI iteration's
# shift, the operator kind's default, SMW around Jacobi BiCGStab to 1e-12)
# and once on complex banded cores (BiCGStab to 10·eps), each held to the
# pair-encoded step: equal ADI iterations, K and LDLᵀ within STEP_REL_TOL.
# 19b: the uncached step on the block-ELL pencil (bs = 128) with the real
# buffer, held to its cached `SparseShiftOps` step.  19c: the north-star
# Newton at capacity NEWTON_FULL_CAPACITY on DIA row shards over a
# world-size-1 NCCL group, held to the same solve without a group: equal
# Newton steps, ADI counts, rebuilds and convergence, θs and line-search λs
# within THETA_REL_TOL, each shift set within SHIFT_SET_TOL (one rank
# repeats the unsharded run's roundings, so its sets are equal; over ranks
# a Penzl Arnoldi carries the all-reduces' rounding differences of K into
# its Ritz values: 5.4e-10 over 2 gloo ranks at n = 256), K and LDLᵀ
# within SHARDED_TOL, residual histories within NEWTON_REL_TOL (or
# under the rounding floor), the last residual confirmed by an independent
# evaluation.  19d: that Newton at N_NEWTON_CPU over NEWTON_CPU_RANKS gloo
# ranks on the host's CPU against one process, held alike.
NEWTON_FULL_CAPACITY = 192
THETA_REL_TOL = 1e-12
SHIFT_SET_TOL = 1e-8
N_NEWTON_CPU = 256
NEWTON_CPU_RANKS = 2
NEWTON_CPU = dict(shifts=(NEWTON_SHIFTS.nshifts, NEWTON_SHIFTS.kp, NEWTON_SHIFTS.km),
                  cfg=(SWEEP_CFG.maxiters, SWEEP_CFG.compression_interval, SWEEP_CFG.r_res),
                  capacity=NEWTON_FULL_CAPACITY, reltol=NEWTON_RELTOL)


class ComplexRoute:
    """Counts the kernel launches made on the complex route
    (`kernels.complex_route.product`: two a complex product, one where only
    the operator or only the operand is complex) while it is active."""

    def __enter__(self):
        self.launches, self._product = 0, complex_route.product

        def counting(launch, parts, X, dim):
            before = k1.launches + k2.launches
            try:
                return self._product(launch, parts, X, dim)
            finally:
                self.launches += k1.launches + k2.launches - before

        complex_route.product = counting
        return self

    def __exit__(self, *exc):
        complex_route.product = self._product
        return False


def counted_run(tag, run):
    """``run()``, a main path, under a `ProductLog` and a `ComplexRoute`: its
    K1 and K2 launches count from 0 (reset just before it, read just after
    it), its wall ends in a synchronize; then each kernel against its plain
    version at every product the run fed it.  Returns (result, wall, {"K1",
    "K2", "complex route", "Krylov": counts}, {kernel: max abs error})."""
    with ProductLog() as products, ComplexRoute() as route:
        s0 = blocklinear.krylov_iterations
        torch.cuda.synchronize()
        reset_launches()  # this path's run starts here
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = {"K1": k1.launches, "K2": k2.launches}  # ... and ends here
        counts.update({"complex route": route.launches,
                       "Krylov": blocklinear.krylov_iterations - s0})
    return out, wall, counts, products.check(tag)


def merge_errs(errs, more):
    for kern, err in more.items():
        errs[kern] = max(errs.get(kern, 0.0), err)


def hold_steps(tag, runs, ref_name):
    """Log each Ros1 step of ``runs`` ({name: ((X, K, iters, res), wall,
    counts)}) and hold it to ``runs[ref_name]``: equal ADI iterations, K and
    LDLᵀ within `STEP_REL_TOL`."""
    (Xr, Kr, itr, _), _, _ = runs[ref_name]
    for name, ((X, K, iters, res), wall, counts) in runs.items():
        dK, dX = rel_diff(K, Kr), lr_rel_diff(X, Xr)
        log(f"{tag} {name}: wall {wall:.3f} s, ADI iters {iters}, res {float(res):.6e}, "
            f"rank {X.k}/{X.r}; launches {counts}; vs {ref_name}: K {dK:.3e}, LDLᵀ {dX:.3e}")
        check(all(bool(torch.isfinite(t).all()) for t in (X.L, X.D, K)),
              f"{tag} {name}: non-finite X or K")
        check(iters == itr and dK <= STEP_REL_TOL and dX <= STEP_REL_TOL,
              f"{tag} {name}: ADI {iters} vs {itr}, K {dK:.3e}, LDLᵀ {dX:.3e} "
              f"(limit {STEP_REL_TOL})")


def phase_uncached_dia(E, A, B, C, dev):
    """Phase 19a.  Returns ({path: K1 launches}, max abs errors)."""
    tag = f"[uncached dia n={N_FULL}]"
    E_op, A_op, B_d, C_d, X0 = full_step_inputs(E, A, B, C, dev)
    F_base = lin_comb(A_op, -1.0 / (2.0 * FULL_STEP_TAU), E_op)
    pair = FULL_STEP_BUFFERS["pair"]
    cores = {"pair-encoded cores": (pair, build_dia_shift_ops(E_op, F_base, pair)),
             "uncached": (SHIFTS, None),
             "complex cores": (SHIFTS, build_dia_shift_ops(E_op, F_base, SHIFTS))}
    log(f"{tag} buffer {SHIFTS} (1-D complex) against its pair encoding; complex cores: "
        f"{cores['complex cores'][1].data.dtype}, {cores['complex cores'][1].cfg.method}")
    runs, errs = {}, {}
    for name, (shifts, lus) in cores.items():
        out, wall, counts, e = counted_run(f"{tag} {name}", lambda s=shifts, c=lus: (
            ros1_step_compiled(E_op, A_op, B_d, C_d, X0, FULL_STEP_TAU, s, FULL_STEP_ABSTOL,
                               FULL_STEP_CFG, c)))
        runs[name] = (out, wall, counts)
        merge_errs(errs, e)
    hold_steps(tag, runs, "pair-encoded cores")
    for name in ("uncached", "complex cores"):
        counts = runs[name][2]
        check(counts["K1"] > 0 and counts["complex route"] > 0,
              f"{tag} {name}: no K1 launch on the complex route ({counts})")
    return {"uncached_ros1": runs["uncached"][2]["K1"],
            "complex_cores_ros1": runs["complex cores"][2]["K1"]}, errs


def phase_uncached_bell(E, A, B, C, dev):
    """Phase 19b.  Returns ({path: K2 launches}, max abs errors)."""
    tag = f"[uncached bell n={N_FULL}]"
    E_b, A_b = bell_pencil(E, A, bs=BS, dtype=torch.float64, device=dev)
    B_d, C_d = (torch.as_tensor(M, dtype=torch.float64, device=dev) for M in (B, C))
    X0 = dryrun.rail_x0(E, C, dev, CAPACITY)
    shifts = FULL_STEP_BUFFERS["real"]
    runs, errs = {}, {}
    for name in ("cached", "uncached"):
        lus = None if name == "uncached" else build_sparse_shift_ops(
            E_b, lin_comb(A_b, -1.0 / (2.0 * FULL_STEP_TAU), E_b), shifts)
        out, wall, counts, e = counted_run(f"{tag} {name}", lambda c=lus: ros1_step_compiled(
            E_b, A_b, B_d, C_d, X0, FULL_STEP_TAU, shifts, FULL_STEP_ABSTOL, FULL_STEP_CFG, c))
        runs[name] = (out, wall, counts)
        merge_errs(errs, e)
        del lus  # the cached step's 1.7 GB of shifted operators
    hold_steps(tag, runs, "cached")
    for name, (_, _, counts) in runs.items():
        check(counts["K2"] > 0, f"{tag} {name}: K2 was not launched")
    return {"uncached_bell_ros1": runs["uncached"][2]["K2"]}, errs


def gare_check(tag, prob, X, info, n):
    """Log a Newton solve's outcome and hold its last residual to an
    independent evaluation (`residual_gare_lowrank` of the whole X on the
    whole operators), as phase 7 does.  Returns the independent one."""
    hist = info["residuals"]
    rel_solver = hist[-1] / hist[0]
    theta = info["thetas"][-1] if info["thetas"] else 1.0
    G_theta = LowRank(L=prob.G.L, D=theta * prob.G.D, k=prob.G.k)
    rel_ind = float(lr_norm(residual_gare_lowrank(prob.E, prob.A, G_theta, prob.Q, X))
                    / lr_norm(prob.Q))
    log(f"{tag}: converged {info['converged']}, {info['newton_steps']} Newton steps, "
        f"{info['shift_rebuilds']} rebuilds, {len(info['thetas'])} theta-stages, ADI iters "
        f"{sum(info['adi_iters'])} in all; final relative residual {rel_solver:.6e} at theta "
        f"{theta:.6e} (independent {rel_ind:.6e}); rank {X.k}/{X.r}")
    floor = n * float(torch.finfo(torch.float64).eps)
    check(bool(np.isfinite(hist).all()), f"{tag}: non-finite residual")
    check(abs(rel_ind - rel_solver) <= RESIDUAL_AGREE_TOL * rel_solver + floor,
          f"{tag}: independent residual {rel_ind:.6e} differs from the solver's "
          f"{rel_solver:.6e} by more than {RESIDUAL_AGREE_TOL}")
    return rel_ind


def hold_newtons(tag, got, ref, diffs, n):
    """Two Newton solves at ``n``, ``got`` and ``ref`` ((info, shift
    sets)): equal steps, ADI counts, rebuilds and convergence, θs and
    line-search λs within `THETA_REL_TOL`, as many shift sets, each within
    `SHIFT_SET_TOL`, residual histories within `NEWTON_REL_TOL` (or under
    the rounding floor n·eps·‖Q‖); ``diffs`` ({name: relative difference})
    within `SHARDED_TOL`."""
    (info, sets), (ref_info, ref_sets) = got, ref
    for key in ("newton_steps", "adi_iters", "shift_rebuilds", "converged"):
        check(info[key] == ref_info[key], f"{tag}: {key} {info[key]} vs {ref_info[key]}")
    for key in ("thetas", "linesearch_lams"):
        a, b = np.asarray(info[key]), np.asarray(ref_info[key])
        check(a.shape == b.shape and np.allclose(a, b, rtol=THETA_REL_TOL, atol=0.0),
              f"{tag}: {key} {a} vs {b}")
    set_diff = max((float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                    for a, b in zip(sets, ref_sets)), default=0.0)
    check(len(sets) == len(ref_sets) and all(a.shape == b.shape for a, b in zip(sets, ref_sets))
          and set_diff <= SHIFT_SET_TOL,
          f"{tag}: shift sets differ ({len(sets)} vs {len(ref_sets)}, {set_diff:.3e})")
    h, hr = np.asarray(info["residuals"]), np.asarray(ref_info["residuals"])
    floor = n * float(torch.finfo(torch.float64).eps) * hr[0]
    check(h.shape == hr.shape and np.allclose(h, hr, rtol=NEWTON_REL_TOL, atol=floor),
          f"{tag}: residual histories differ beyond {NEWTON_REL_TOL}")
    log(f"{tag}: sharded vs one process: {info['newton_steps']} steps, rebuilds "
        f"{info['shift_rebuilds']}, {len(sets)} shift sets within {set_diff:.3e}; "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()))
    check(all(v <= SHARDED_TOL for v in diffs.values()), f"{tag}: {diffs} beyond {SHARDED_TOL}")


def phase_newton_shards(E, A, B, C, dev):
    """Phase 19c.  Returns ({path: K1 launches}, max abs errors)."""
    tag = f"[newton shards n={N_FULL}]"
    prob = newton_problem(E, A, B, C, dev)
    kw = dict(shifts=NEWTON_SHIFTS, cfg=SWEEP_CFG, capacity=NEWTON_FULL_CAPACITY,
              maxiters=NEWTON_MAXITERS, reltol=NEWTON_RELTOL)
    log(f"{tag} capacity {NEWTON_FULL_CAPACITY}, reltol {NEWTON_RELTOL}, {NEWTON_SHIFTS}")

    def run(m):
        c0 = collections.Counter(mesh_mod.collectives)
        t = time.perf_counter()
        # Row shards rebuild on the host; so does their twin here.
        with warnings.catch_warnings(), shift_route(False):
            warnings.simplefilter("ignore")  # the outcome is logged below
            out, peak = with_peak(lambda: dryrun.newton_solve(prob.E, prob.A, prob.G, prob.Q,
                                                              m, **kw))
        torch.cuda.synchronize()
        return out, peak, time.perf_counter() - t, dict(mesh_mod.collectives - c0)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, timeout=GROUP_TIMEOUT)
    try:
        outs, errs = run_twins(tag, run, make_mesh(1))
    finally:
        dist.destroy_process_group()
    ((X, K, info, sets, kry), peak, wall, coll), l1, _ = outs["sharded"]
    ((Xr, Kr, info_r, sets_r, kry_r), peak_r, wall_r, _), l1_r, _ = outs["unsharded"]
    steps = max(info["newton_steps"], 1)
    per_step = ", ".join(f"{k} {v / steps:.1f}" for k, v in coll.items())
    log(f"{tag} wall {wall:.3f} s sharded, {wall_r:.3f} s unsharded; K1 launches {l1} / "
        f"{l1_r}; Krylov {kry} / {kry_r}; collectives {coll} ({per_step} per Newton step); "
        f"peak device memory above the run's start {peak:.3f} / {peak_r:.3f} GiB; {card_line()}")
    for name, (Xn, info_n) in (("sharded", (X, info)), ("unsharded", (Xr, info_r))):
        check(all(bool(torch.isfinite(t).all()) for t in (Xn.L, Xn.D, K, Kr)),
              f"{tag} {name}: non-finite X or K")
        gare_check(f"{tag} {name}", prob, Xn, info_n, N_FULL)
    hold_newtons(tag, (info, sets), (info_r, sets_r),
                 {"K": rel_diff(K, Kr), "LDLᵀ": lr_rel_diff(X, Xr)}, N_FULL)
    check(abs(kry - kry_r) <= KRYLOV_REL_TOL * kry_r, f"{tag}: Krylov {kry} vs {kry_r}")
    check(l1["f64"] > 0 and l1 == l1_r, f"{tag}: K1 launches {l1} sharded, {l1_r} unsharded")
    return {"sharded_newton_full": l1["f64"]}, errs


def newton_cpu_run(dev, n, mesh=None):
    """Phase 19d's Newton at ``n`` on ``dev`` (over ``mesh`` if given):
    numpy LDLᵀ and K, info, shift sets."""
    X, K, info, sets, _ = dryrun.rail_newton(dev, n, mesh, NEWTON_MAXITERS, **NEWTON_CPU)
    return (X.L @ X.D @ X.L.T).numpy(), K.numpy(), info, sets


def newton_cpu_rank(dev, n):
    """Phase 19d's rank: `newton_cpu_run` over the group's ranks."""
    return newton_cpu_run(dev, n, make_mesh(device=dev.type))


def phase_newton_cpu():
    """Phase 19d: 19c's Newton at `N_NEWTON_CPU` over `NEWTON_CPU_RANKS`
    gloo ranks on the host's CPU against one process (run meanwhile)."""
    tag = f"[newton shards n={N_NEWTON_CPU}, {NEWTON_CPU_RANKS} gloo ranks]"

    def timed(fn, *args):
        t = time.perf_counter()
        return fn(*args), time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(timed, dryrun.run_ranks, newton_cpu_rank, NEWTON_CPU_RANKS, "cpu",
                            (N_NEWTON_CPU,))
        (Xr, Kr, info_r, sets_r), wall_r = timed(newton_cpu_run, torch.device("cpu"),
                                                 N_NEWTON_CPU)
        (X, K, info, sets), wall = ranks.result()
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    log(f"{tag}: {wall:.3f} s (spawn included), one process {wall_r:.3f} s, both at once; "
        f"converged {info['converged']}, last relative residual "
        f"{info['residuals'][-1] / info['residuals'][0]:.6e}")
    hold_newtons(tag, (info, sets), (info_r, sets_r), {"K": rel(K, Kr), "LDLᵀ": rel(X, Xr)},
                 N_NEWTON_CPU)


def phase_uncached(E, A, B, C, dev, k1_launches, k2_launches):
    """Phase 19: 19a–c on the card, then 19d on the host's CPU.  Adds the
    launches per path to ``k1_launches`` and ``k2_launches``; returns the
    kernels' max abs errors."""
    t0 = time.perf_counter()
    errs = {}
    for part, launches in ((phase_uncached_dia, k1_launches), (phase_uncached_bell, k2_launches),
                           (phase_newton_shards, k1_launches)):
        t = time.perf_counter()
        l, e = part(E, A, B, C, dev)
        launches.update(l)
        merge_errs(errs, e)
        log(f"[uncached] {part.__name__} took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_newton_cpu()
    log(f"[uncached] phase_newton_cpu took {time.perf_counter() - t:.1f} s")
    log(f"[uncached] phase 19 took {time.perf_counter() - t0:.1f} s; {card_line()}")
    return errs


# Phase 20: the fused CG iteration.  Kernel vs plain: the kernels' sums end
# in a fixed order of their own, torch's in another, and the block product
# sums in the order of b (the plain one through cuBLAS); both within
# `REL_TOL`.  A step through the fused iteration against the present loop:
# the same CG, only the last bits of the dots differ.
FUSED_WIDTHS = (7, 48)
FUSED_MU = -0.5
FUSED_STEP_TOL = 1e-12


@contextlib.contextmanager
def unfused():
    """The present `_cg` loop in place of the fused iteration: the route's
    choice (`KrylovSolver._fused`) patched to refuse every solve."""
    choose = blocklinear.KrylovSolver._fused
    blocklinear.KrylovSolver._fused = lambda self, B: False
    try:
        yield
    finally:
        blocklinear.KrylovSolver._fused = choose


def fused_cases(E, A, dev):
    """{(format, preconditioner, dtype): (operator, prec, axis)}: ``A + μE``
    (= ``Aᵀ + μEᵀ``: the surrogate is symmetric) at n=79841 in DIA (the
    lane-major state) and block-ELL (the column-major one), with its
    128-wide block-Jacobi inverses, and on DIA its Jacobi diagonal too."""
    dt = torch.float64
    E_d, A_d = dia_pencil(E, A, dtype=dt, device=dev)
    E_b, A_b = bell_pencil(E, A, bs=BS, dtype=dt, device=dev)
    cases = {}
    for fmt, op, axis in (("dia", lin_comb(A_d, FUSED_MU, E_d), 1),
                          ("bell", lin_comb(A_b, FUSED_MU, E_b), 0)):
        for dt in (torch.float64, torch.float32):
            o = op_astype(op, dt)
            blocks = o.diag_blocks(BS) if fmt == "dia" else o.diag_blocks()
            cases[(fmt, "block_jacobi", dt)] = (o, blocklinear.block_jacobi_inverses(blocks), axis)
            if fmt == "dia":
                cases[(fmt, "jacobi", dt)] = (o, 1.0 / o.diag(), axis)
    return cases


def fused_pair(op, prec, axis, q, dt):
    """A workspace of random state on the card for the kernels, its twin
    for the plain versions (one-entry sums), and the product ``a = F·p``."""
    gen = torch.Generator(device=CARD).manual_seed(20 + q)
    shape = (q, op.N) if axis == 1 else (op.n, q)

    def rnd():
        return torch.randn(shape, generator=gen, dtype=dt, device=CARD)

    ws = cg_fused.workspace(rnd(), rnd(), prec, -1.0, axis, torch.ones((), dtype=dt, device=CARD))
    ws.p.copy_(rnd())
    ws.z.copy_(rnd())
    one = lambda: torch.zeros(1, dtype=dt, device=CARD)  # noqa: E731
    tw = dataclasses.replace(ws, x=ws.x.clone(), r=ws.r.clone(), z=ws.z.clone(),
                             p=ws.p.clone(), sc=ws.sc.clone(), flag=ws.flag.clone(),
                             part_pap=one(), part_rr=one(), part_rz=one(), launch=None)
    a = op.mmT(ws.p) if axis == 1 else op.mm(ws.p)
    return ws, tw, a.contiguous()


def check_sum(name, parts, ref, dname):
    got, want = float(parts.double().sum()), float(ref.double().sum())
    rel = abs(got - want) / max(abs(want), 1e-300)
    check(math.isfinite(got) and rel <= REL_TOL[dname], f"{name}: sum rel err {rel:.3e}")
    return rel


def fused_kernels_check(tag, op, prec, axis, q, dt):
    """Each kernel against its plain version on one random state, in the
    iteration's order; returns the largest relative error, the largest
    absolute error of the vectors it writes, and the pair's state."""
    dname = str(dt).removeprefix("torch.")
    ws, tw, a = fused_pair(op, prec, axis, q, dt)
    errs, abs_errs = [], []

    def close(name, got, ref):
        abs_err, rel_err = check_close(name, got, ref, dname)
        abs_errs.append(abs_err)
        return rel_err

    cg_fused.pap(ws, a)
    cg_fused.pap_plain(tw, a)
    errs.append(check_sum(f"{tag} pap", ws.part_pap, tw.part_pap, dname))
    cg_fused.precond(ws)
    cg_fused.precond_plain(tw)
    errs.append(close(f"{tag} precond z", ws.z, tw.z))
    errs.append(check_sum(f"{tag} precond <r, z>", ws.part_rz, tw.part_rz, dname))
    tw = dataclasses.replace(tw, part_pap=ws.part_pap, part_rz=ws.part_rz)  # the kernels' sums
    cg_fused.update(ws, a)
    cg_fused.update_plain(tw, a)
    errs += [close(f"{tag} update {v}", getattr(ws, v), getattr(tw, v)) for v in ("x", "r")]
    errs.append(check_sum(f"{tag} update gamma", ws.sc[:1], tw.sc[:1], dname))
    errs.append(check_sum(f"{tag} update <r, r>", ws.part_rr, tw.part_rr, dname))
    tw = dataclasses.replace(tw, part_rr=ws.part_rr)
    cg_fused.direction(ws)
    cg_fused.direction_plain(tw)
    errs.append(close(f"{tag} direction p", ws.p, tw.p))
    check(int(ws.flag) == int(tw.flag), f"{tag} direction: flag {int(ws.flag)} vs {int(tw.flag)}")
    torch.cuda.synchronize()
    return max(errs), max(abs_errs), (ws, tw, a)


def fused_timings(tag, op, prec, ws, tw, a):
    """Each kernel's and plain version's device time (CUDA events) beside
    the bound: the bytes each must move (the block product's operations)."""
    V = ws.p.numel() * ws.p.element_size()
    inv_bytes = prec.numel() * prec.element_size()
    q = ws.p.shape[1 - ws.axis]
    flops = 2.0 * q * prec.shape[1] ** 2 * prec.shape[0] if prec.dim() == 3 else 2.0 * q * op.n
    rows = {}
    for name, kern, plain, nbytes, fl in (
            ("cg_pap", lambda: cg_fused.pap(ws, a), lambda: cg_fused.pap_plain(tw, a), 2 * V, 0),
            ("cg_update", lambda: cg_fused.update(ws, a), lambda: cg_fused.update_plain(tw, a),
             6 * V, 0),
            ("cg_precond", lambda: cg_fused.precond(ws), lambda: cg_fused.precond_plain(tw),
             2 * V + inv_bytes, flops),
            ("cg_direction", lambda: cg_fused.direction(ws), lambda: cg_fused.direction_plain(tw),
             3 * V, 0)):
        t, _ = time_ms(kern)
        t_plain, _ = time_ms(plain)
        bound, by = bound_ms(nbytes, fl, ws.p.dtype)
        rows[name] = {"ms": t, "plain_ms": t_plain, "bound_ms": bound, "bound_by": by}
        log(f"{tag} {name}: {t * 1e3:.2f} us (bound {bound * 1e3:.2f} us by {by}, "
            f"{share(bound, t)}); plain {t_plain * 1e3:.2f} us")
    total = sum(r["ms"] for r in rows.values())
    log(f"{tag} the four kernels: {total * 1e3:.2f} us a CG iteration, bound "
        f"{sum(r['bound_ms'] for r in rows.values()) * 1e3:.2f} us")
    return rows


def solve_profile(solver, W):
    """One solve under the profiler: its result, Krylov iterations, wall,
    kernels by kind (the fused kernels, K1/K2, others) and copies, and the
    launch counters' deltas."""
    from torch.profiler import ProfilerActivity, profile

    s0, l0 = blocklinear.krylov_iterations, (cg_fused.launches, k1.launches, k2.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x = solver.solve(W)
        torch.cuda.synchronize()
    iters = blocklinear.krylov_iterations - s0
    kinds, device_us = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name
        kind = ("copy" if name.startswith(("Memcpy", "Memset")) else
                "fused" if "cg_" in name else
                "spmm" if ("dia_" in name or "bell_spmm" in name) else "other")
        kinds[kind] += 1
        device_us[kind] += e.device_time_total
    log("    device µs a kernel: " + ", ".join(
        f"{k} {device_us[k] / kinds[k]:.1f}" for k in sorted(kinds)))
    counters = {"fused": cg_fused.launches - l0[0],
                "spmm": k1.launches - l0[1] + k2.launches - l0[2]}
    torch.cuda.synchronize()
    t = time.perf_counter()
    solver.solve(W)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return x, iters, wall, dict(kinds), counters


def fused_solves(tag, op, prec, q):
    """One CG solve of ``(−op)X = −W`` (negate, as the cores) at width ``q``
    through the fused iteration and the present loop: launches and wall per
    CG iteration, and the solutions held to each other."""
    cfg = default_dia_krylov(op.dtype, False)
    solver = blocklinear.KrylovSolver(op=op, prec=prec, cfg=cfg)
    W = torch.randn((op.n, q), generator=torch.Generator(device=CARD).manual_seed(q),
                    dtype=op.dtype, device=CARD)
    solver.solve(W)  # warm: allocator, cuBLAS handles
    out = {}
    for name in ("fused", "present"):
        with (contextlib.nullcontext() if name == "fused" else unfused()):
            x, iters, wall, kinds, counters = solve_profile(solver, W)
        per = {k: v / iters for k, v in kinds.items()}
        out[name] = (x, iters, wall)
        log(f"{tag} q={q} {name}: {iters} CG iterations, {wall * 1e6 / iters:.1f} us each "
            f"(wall {wall:.4f} s); per iteration: profiler "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(per.items()))
            + "; launch counters " + ", ".join(f"{k} {v / iters:.2f}"
                                               for k, v in sorted(counters.items())))
        if name == "fused":
            check(counters["fused"] >= 4 * iters, f"{tag} q={q}: the fused kernels did not run")
            loop = per.get("fused", 0.0) + per.get("spmm", 0.0)
            check(not kinds or loop <= 5.5, f"{tag} q={q}: {loop:.2f} kernels a CG iteration "
                                            "in the fused loop, more than 4 and the SpMM")
    (xf, kf, wf), (xp, kp, wp) = out["fused"], out["present"]
    d = rel_diff(xf, xp)
    log(f"{tag} q={q}: fused vs present: iterations {kf} / {kp}, x {d:.3e}, "
        f"wall per CG iteration {wf * 1e6 / kf:.1f} / {wp * 1e6 / kp:.1f} us")
    check(abs(kf - kp) <= 1 and d <= 1e-10, f"{tag} q={q}: fused {kf} vs present {kp}, x {d:.3e}")
    return {"iters": (kf, kp), "us_per_iter": (wf * 1e6 / kf, wp * 1e6 / kp)}


def hold_fused(tag, runs):
    """Hold the fused run of a step to the present loop's: equal ADI and
    Krylov iterations, K and LDLᵀ within `FUSED_STEP_TOL`."""
    (Xf, Kf, itf, *_), wf, cf = runs["fused"]
    (Xp, Kp, itp, *_), wp, cp = runs["present"]
    dK, dX = rel_diff(Kf, Kp), lr_rel_diff(Xf, Xp)
    log(f"{tag}: fused {wf:.3f} s, present {wp:.3f} s; ADI {itf} / {itp}; Krylov "
        f"{cf['Krylov']} / {cp['Krylov']} (fused {cf['fused']}); K {dK:.3e}, LDLᵀ {dX:.3e}")
    check(all(bool(torch.isfinite(t).all()) for t in (Xf.L, Xf.D, Kf)), f"{tag}: non-finite")
    check(itf == itp and cf["Krylov"] == cp["Krylov"] and cf["fused"] == cf["Krylov"]
          and cp["fused"] == 0, f"{tag}: iterations differ ({itf}/{itp}, {cf}/{cp})")
    check(dK <= FUSED_STEP_TOL and dX <= FUSED_STEP_TOL,
          f"{tag}: K {dK:.3e}, LDLᵀ {dX:.3e} beyond {FUSED_STEP_TOL}")


def fused_run(tag, run):
    """``run()`` through the present loop and the fused iteration, in the
    order present, fused, fused, present (the walls of all four logged):
    {name: (result, wall, {"K1", "K2", "Krylov", "fused": counts})} of the
    second run of each."""
    runs, walls = {}, []
    for name in ("present", "fused", "fused", "present"):
        f0 = blocklinear.krylov_fused_iterations
        with (contextlib.nullcontext() if name == "fused" else unfused()):
            out, wall, counts, _ = counted_run(f"{tag} {name}", run)
        counts["fused"] = blocklinear.krylov_fused_iterations - f0
        runs[name] = (out, wall, counts)
        walls.append(f"{name} {wall:.3f} s")
    log(f"{tag} walls: " + ", ".join(walls))
    return runs


def phase_fused_steps(E, A, B, C, dev):
    """Phase 20c: phase 3's all-real-buffer Ros1 step (CG over K1) and one
    step of phase 5's block-ELL Ros2 sweep (CG over K2)."""
    tag = f"[fused dia ros1 n={N_FULL}]"
    E_op, A_op, B_d, C_d, X0 = full_step_inputs(E, A, B, C, dev)
    F_base = lin_comb(A_op, -1.0 / (2.0 * FULL_STEP_TAU), E_op)
    real = FULL_STEP_BUFFERS["real"]
    ops = build_dia_shift_ops(E_op, F_base, real)
    check(ops.cfg.method == "cg", f"{tag}: the all-real buffer runs {ops.cfg.method}")
    hold_fused(tag, fused_run(tag, lambda: ros1_step_compiled(
        E_op, A_op, B_d, C_d, X0, FULL_STEP_TAU, real, FULL_STEP_ABSTOL, FULL_STEP_CFG, ops)))
    del ops, E_op, A_op
    tag = f"[fused bell ros2 n={N_FULL}]"
    E_b = bell_pencil(E, A, bs=BS, dtype=torch.float64, device=dev)
    prob, shifts, _ = ros2_problem(E, A, B, C, E_b, dev, 1, CAPACITY)

    def step():
        iters = []
        sol = solve_gdre_ros2_compiled(prob, dt=-TAU, shifts=shifts, cfg=SWEEP_CFG,
                                       capacity=CAPACITY,
                                       observer=lambda i, X, K, it, res: iters.append(it))
        return sol.X[-1], sol.K[-1], iters[1:]

    hold_fused(tag, fused_run(tag, step))


def phase_fused_gale(E, A, C, dev):
    """Phase 20d: phase 15's compiled GALE (CG over K1 on each real shift)
    with the f32 core and with the f64 core, each through the present loop
    and the fused iteration: equal ADI iterations, Krylov iterations within
    one, LDLᵀ within `MIXED_REL_TOL`, and each run's tracked residual
    confirmed by the independent evaluation (`run_gale_mixed`'s ``true``,
    at twice the residual's rank) as phase 15 confirms it."""
    floor = HOST_FLOOR_FACTOR * N_FULL * float(torch.finfo(torch.float64).eps)
    for sd in ("float32", None):
        tag = f"[fused gale {sd or 'float64'} core n={N_FULL}]"
        runs = {}
        for name in ("present", "fused"):
            f0 = blocklinear.krylov_fused_iterations
            with (unfused() if name == "present" else contextlib.nullcontext()):
                out, wall, counts, _ = counted_run(f"{tag} {name}",
                                                   lambda: run_gale_mixed(E, A, C, dev, sd))
            counts["fused"] = blocklinear.krylov_fused_iterations - f0
            runs[name] = (out, counts)
            log(f"{tag} {name}: wall {out['wall']:.3f} s, ADI iterations {out['iters']}, "
                f"Krylov {counts['Krylov']} ({counts['fused']} fused) in {out['solves']} "
                f"solves, tracked relative residual {out['tracked']:.9e}, independent "
                f"{out['true']:.9e}")
            check(np.isfinite(out["true"]) and abs(out["true"] - out["tracked"])
                  <= RESIDUAL_AGREE_TOL * out["tracked"] + floor,
                  f"{tag} {name}: the independent residual {out['true']:.3e} does not "
                  f"confirm the tracked one {out['tracked']:.3e}")
        (f, cf), (p, cp) = runs["fused"], runs["present"]
        dX = lr_rel_diff(f["X"], p["X"])
        d_true = abs(f["true"] - p["true"]) / p["true"]
        d_tracked = abs(f["tracked"] - p["tracked"]) / p["tracked"]
        log(f"{tag} fused vs present: ADI {f['iters']} / {p['iters']}, Krylov "
            f"{cf['Krylov']} / {cp['Krylov']}; LDLᵀ {dX:.3e}; independent residual "
            f"{d_true:.3e} apart ({abs(f['true'] - p['true']):.3e} of ‖C‖), tracked "
            f"{d_tracked:.3e} apart")
        check(f["iters"] == p["iters"] and abs(cf["Krylov"] - cp["Krylov"]) <= 1
              and cf["fused"] == cf["Krylov"] > 0 and cp["fused"] == 0,
              f"{tag}: iterations differ ({f['iters']}/{p['iters']}, {cf}/{cp})")
        check(dX <= MIXED_REL_TOL, f"{tag}: LDLᵀ {dX:.3e} beyond {MIXED_REL_TOL}")
        del runs, f, p


def phase_fused(E, A, B, C, dev):
    """Phase 20: the fused CG iteration (20a kernels vs plain, 20b solves,
    20c steps, 20d the f32-core GALE).  Returns (the worst relative and
    absolute kernel errors, the q = 48 f64 timings of the DIA state)."""
    t0 = time.perf_counter()
    cases = fused_cases(E, A, dev)
    worst, worst_abs, timings, solves = 0.0, 0.0, {}, {}
    for (fmt, pk, dt), (op, prec, axis) in cases.items():
        for q in FUSED_WIDTHS:
            dname = str(dt).removeprefix("torch.")
            tag = f"[fused {fmt} {pk} {dname} q={q}]"
            err, err_abs, state = fused_kernels_check(tag, op, prec, axis, q, dt)
            worst, worst_abs = max(worst, err), max(worst_abs, err_abs)
            log(f"{tag} each kernel = plain, worst rel {err:.3e} (limit {REL_TOL[dname]:g})")
            if q == 48 and dt == torch.float64 and pk == "block_jacobi":
                timings[fmt] = fused_timings(tag, op, prec, *state)
            del state
        if dt == torch.float64 and pk == "block_jacobi":
            solves[fmt] = {q: fused_solves(f"[fused {fmt} solve]", op, prec, q)
                           for q in FUSED_WIDTHS}
    del cases
    phase_fused_steps(E, A, B, C, dev)
    phase_fused_gale(E, A, C, dev)
    log(f"[fused] phase 20 took {time.perf_counter() - t0:.1f} s; {card_line()}")
    log(json.dumps({"fused_cg": {"kernels": timings, "solves": {
        f: {str(q): v for q, v in d.items()} for f, d in solves.items()},
        "max_rel_err": worst, "max_abs_err": worst_abs}}))
    return worst, worst_abs, timings["dia"]


# Phase 21: the closed-loop Penzl rebuild on the card.  The factors' solves
# against SuperLU: both are direct solves of matrices with condition
# numbers under 200, so they agree to rounding.
CHOLESKY_REL_TOL = 1e-12
# Feedbacks of the rebuild: ``K = c·Bᵀ`` keeps ``A − BK`` symmetric and
# stable.  The first is the open loop, as at the Newton's first rebuild; the
# second, warm-started, moves the pencil.  A warm start is a converged Ritz
# vector, so a warm rebuild on a pencil that barely moved draws its other
# Ritz values from rounding: the host route's own set then moves by up to
# 1e-3 when its start moves by 1e-15 (the Rail surrogate at n=1357, K from
# 10·Bᵀ to 10.5·Bᵀ).  The phase prints that spread of the host route beside
# the routes' gap.
REBUILD_GAINS = (0.0, 10.0)


def device_ms_covered(fn, host_ms: float) -> float:
    """Median device time of one call over `TIMED_CALLS` calls (CUDA
    events) behind a sleep kernel long enough to cover the enqueue of all
    of them at ``host_ms`` a call: `time_ms`'s fixed sleep covers about
    50 ms, and calls enqueued after it has run read the host's pace."""
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    torch.cuda._sleep(10_000_000)
    probe[1].record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / probe[0].elapsed_time(probe[1])
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_CALLS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_CALLS)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2.0 * TIMED_CALLS * host_ms * cycles_per_ms))
    for st, e in zip(starts, ends):
        st.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(st.elapsed_time(e) for st, e in zip(starts, ends))


def phase_shifts_card(E, A, B, dev):
    """Phase 21: the closed-loop Penzl rebuild through
    `heuristic_shifts_card` against `heuristic_shifts_host`."""
    tag = f"[shifts card n={N_FULL}]"
    t_phase = time.perf_counter()
    E_op, A_op = dia_pencil(E, A, dtype=torch.float64, device=dev)
    x = np.random.default_rng(21).standard_normal(N_FULL)
    x_d = torch.as_tensor(x, device=dev)
    for name, op, M, neg in (("E", E_op, E, False), ("-A", A_op, A, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fact = dia_cholesky(op, negate=neg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ref = spla.splu(sp.csc_matrix(M)).solve(x)
        y = fact.solve(x_d).cpu().numpy()
        err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
        app_ms, app_host = time_ms(lambda: fact.solve(x_d))
        dev_ms = device_ms_covered(lambda: fact.solve(x_d), app_host)
        X7 = torch.as_tensor(np.random.default_rng(7).standard_normal((N_FULL, B.shape[1])),
                             device=dev)
        _, host7 = time_ms(lambda: fact.solve(X7))
        dev7 = device_ms_covered(lambda: fact.solve(X7), host7)
        log(f"{tag} factor of {name}: block {fact.b}, {len(fact.levels)} levels, "
            f"{fact.nbytes / 1e9:.3f} GB, built in {build_s * 1e3:.1f} ms; one application "
            f"{dev_ms:.3f} ms of device behind a covering sleep, {app_ms:.3f} ms by "
            f"time_ms, {app_host:.3f} ms enqueue; {B.shape[1]} columns {dev7:.3f} ms of "
            f"device ({host7:.3f} ms enqueue); vs SuperLU rel {err:.3e}")
        check(err <= CHOLESKY_REL_TOL,
              f"{tag} {name}: solve {err:.3e} from SuperLU beyond {CHOLESKY_REL_TOL}")
        del fact
    B_d = torch.as_tensor(B, device=dev)
    host_cache, card_cache = {}, {}
    for i, gain in enumerate(REBUILD_GAINS):
        warm = i > 0
        k = NEWTON_SHIFTS.kp // 2 if warm else NEWTON_SHIFTS.kp
        K = gain * B.T
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        # Twice on the same input: the first call's wall and the second's.
        walls, given = [], dict(card_cache)
        for _ in range(2):
            card_cache = dict(given)
            t0 = time.perf_counter()
            card = shift_mod.heuristic_shifts_card(
                E_op, A_op, NEWTON_SHIFTS.nshifts, k, k, B=B_d,
                K=torch.as_tensor(K, device=dev), cache=card_cache, warm_start=warm)
            walls.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        starts = dict(host_cache)
        t0 = time.perf_counter()
        host = heuristic_shifts_host(E, A, NEWTON_SHIFTS.nshifts, k, k, B=B, K=K,
                                     lu_cache=host_cache, warm_start=warm)
        host_s = time.perf_counter() - t0
        hs, cs = np.sort_complex(np.asarray(host)), np.sort_complex(np.asarray(card))
        gap = float(np.max(np.abs(hs - cs) / np.abs(hs))) if len(hs) == len(cs) else math.inf
        spread = ""
        if warm:
            rng = np.random.default_rng(21)
            moved = {key: v + 1e-15 * rng.standard_normal(v.shape)
                     for key, v in starts.items() if key.startswith("warm")}
            again = np.sort_complex(np.asarray(heuristic_shifts_host(
                E, A, NEWTON_SHIFTS.nshifts, k, k, B=B, K=K,
                lu_cache=dict(starts, **moved), warm_start=True)))
            spread = (f"; the host's own set moves {np.max(np.abs(hs - again) / np.abs(hs)):.3e} "
                      "for a warm start moved by 1e-15 an entry")
        log(f"{tag} rebuild K = {gain:g}·Bᵀ, {k} + {k} steps, {'warm' if warm else 'cold'}: "
            f"card {walls[0]:.3f} s, again {walls[1]:.3f} s (peak {peak:.3f} GB above the "
            f"{base / 1e9:.3f} GB held), "
            f"host {host_s:.3f} s; shift sets {gap:.3e} apart{spread}")
        check(gap <= SHIFT_SET_TOL, f"{tag}: shift sets {gap:.3e} apart")
    log(f"{tag} phase 21 took {time.perf_counter() - t_phase:.1f} s; {card_line()}")


def checked(tag, kern, run):
    """``run()``, a full-size main path that returns its launches, under a
    `ProductLog`; then the kernels against their plain versions at every
    product it fed them.  Returns (launches, max abs error of ``kern``)."""
    with ProductLog() as products:
        launches = run()
    return launches, products.check(tag).get(kern, 0.0)


def kernel_line(name, launches, max_abs, timing, library, bound):
    """One kernel's entry; ``launches`` maps each main path to its count."""
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max_abs, "ms": timing[0],
            "plain_ms": timing[1], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--newton-only", action="store_true",
                    help="build the kernels and run only the full-size Newton phase")
    ap.add_argument("--newton-capacity", type=int, default=CAPACITY,
                    help="capacity of X in the full-size Newton phase (default %(default)s)")
    ap.add_argument("--host-only", action="store_true",
                    help="build the kernels and run only the host-API phases 8 to 11")
    ap.add_argument("--dense-only", action="store_true",
                    help="build the kernels and run only the dense phases 12 and 13")
    ap.add_argument("--gmres-only", action="store_true",
                    help="build the kernels and run only the GMRES phase 14 (with "
                         "--mixed-only: phases 14 and 15)")
    ap.add_argument("--mixed-only", action="store_true",
                    help="build the kernels and run only the mixed-precision phase 15")
    ap.add_argument("--parareal-only", action="store_true",
                    help="build the kernels and run only the parareal and sharded-product "
                         "phase 16")
    ap.add_argument("--sharded-only", action="store_true",
                    help="build the kernels and run only the row-sharded phases 17 and 18")
    ap.add_argument("--uncached-only", action="store_true",
                    help="build the kernels and run only phase 19 (the uncached route, "
                         "complex banded cores, the full Newton on row shards)")
    ap.add_argument("--krylov-only", action="store_true",
                    help="build the kernels and run only phase 20 (the fused CG iteration)")
    ap.add_argument("--shifts-only", action="store_true",
                    help="build the kernels and run only phase 21 (the closed-loop Penzl "
                         "rebuild on the card)")
    args = ap.parse_args()
    only = args.newton_only or args.host_only or args.dense_only or args.gmres_only \
        or args.mixed_only or args.parareal_only or args.sharded_only or args.uncached_only \
        or args.krylov_only or args.shifts_only
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
        if args.newton_only:
            checked(f"[n={N_FULL} newton]", "K1",
                    lambda: phase_newton_full(E, A, B, C, dev, args.newton_capacity))
        elif args.dense_only:
            phase_dense_small()
            checked(f"[dense n={N_DENSE}]", "K1", phase_dense_full)
        elif args.host_only:
            phase_host_small()
            phase_complex()
            phase_host_full(E, A, B, C, dev)
            phase_host_bell(E, A, B, C, bell_pencil(E, A, bs=BS, dtype=torch.float64, device=dev))
        elif args.parareal_only:
            k1_launches, k2_launches = {}, {}
            phase_parareal(E, A, B, C, dev, k1_launches, k2_launches)
            log(f"[launches] K1 {k1_launches}; K2 {k2_launches}")
        elif args.sharded_only:
            k1_launches, k2_launches = {}, {}
            phase_sharded(E, A, B, C, dev, k1_launches)
            phase_shards(E, A, B, C, dev, k1_launches, k2_launches)
            log(f"[launches] K1 {k1_launches}; K2 {k2_launches}")
        elif args.krylov_only:
            phase_fused(E, A, B, C, dev)
        elif args.shifts_only:
            phase_shifts_card(E, A, B, dev)
        elif args.uncached_only:
            k1_launches, k2_launches = {}, {}
            phase_uncached(E, A, B, C, dev, k1_launches, k2_launches)
            log(f"[launches] K1 {k1_launches}; K2 {k2_launches}")
        elif args.gmres_only or args.mixed_only:
            k1_launches, k2_launches = {}, {}
            if args.gmres_only:
                phase_gmres(E, A, B, C, dev, k1_launches)
            if args.mixed_only:
                phase_mixed(E, A, B, C, dev, k1_launches, k2_launches)
            log(f"[launches] K1 {k1_launches}; K2 {k2_launches}")
        else:
            k1_err, k1_t, k1_cold, k1_lib, k1_bound = phase_kernels(E, A, dev)
            t0 = time.perf_counter()
            E_b = bell_pencil(E, A, bs=BS, dtype=torch.float64, device=dev)
            torch.cuda.synchronize()
            log(f"[n={N_FULL} bell] block-ELL pencil built on the host and uploaded in "
                f"{time.perf_counter() - t0:.2f} s: data {tuple(E_b[0].data.shape)}, "
                f"{E_b[0].data.numel() * 8 / 1e6:.1f} MB per array in f64")
            k2_err, k2_t, k2_lib, k2_bound = phase_k2(E_b, E, A, dev)
            phase_small_step()
            launches, err = checked(f"[n={N_FULL} dia ros1]", "K1",
                                    lambda: phase_full_step(E, A, B, C, dev))
            k1_launches, k1_err = {"dia_ros1": launches}, max(k1_err, err)
            phase_bell_small()
            launches, err = checked(f"[n={N_FULL} bell ros2]", "K2",
                                    lambda: phase_bell_full(E, A, B, C, E_b, dev))
            k2_launches, k2_err = {"bell_ros2": launches}, max(k2_err, err)
            launches, err = phase_host_bell(E, A, B, C, E_b)
            k2_launches.update(launches)
            k2_err = max(k2_err, err)
            del E_b  # the Newton paths' peak memory is their own
            phase_newton_small()
            launches, err = checked(f"[n={N_FULL} newton]", "K1", lambda: phase_newton_full(
                E, A, B, C, dev, args.newton_capacity))
            k1_launches["gare_newton"], k1_err = launches, max(k1_err, err)
            phase_host_small()
            phase_complex()
            launches, err = phase_host_full(E, A, B, C, dev)
            k1_launches.update(launches)
            k1_err = max(k1_err, err)
            phase_dense_small()
            launches, err = checked(f"[dense n={N_DENSE}]", "K1", phase_dense_full)
            k1_launches.update(launches)
            k1_err = max(k1_err, err)
            errs = phase_gmres(E, A, B, C, dev, k1_launches)
            k1_err = max(k1_err, errs.get("K1", 0.0))
            errs = phase_mixed(E, A, B, C, dev, k1_launches, k2_launches)
            k1_err = max(k1_err, errs.get("K1", 0.0))
            k2_err = max(k2_err, errs.get("K2", 0.0))
            errs = phase_parareal(E, A, B, C, dev, k1_launches, k2_launches)
            k1_err = max(k1_err, errs["K1"])
            k2_err = max(k2_err, errs["K2"])
            k1_err = max(k1_err, phase_sharded(E, A, B, C, dev, k1_launches))
            errs = phase_shards(E, A, B, C, dev, k1_launches, k2_launches)
            k1_err = max(k1_err, errs.get("K1", 0.0))
            k2_err = max(k2_err, errs.get("K2", 0.0))
            errs = phase_uncached(E, A, B, C, dev, k1_launches, k2_launches)
            k1_err = max(k1_err, errs.get("K1", 0.0))
            k2_err = max(k2_err, errs.get("K2", 0.0))
            _, cg_err, cg_t = phase_fused(E, A, B, C, dev)
            phase_shifts_card(E, A, B, dev)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if not only:
        key1, key2 = ("mmT", "float64", 48), ("mm", "float64", 48)
        # K1's time is the cold one: its operands are not in the L2, as its
        # bound assumes.
        log(json.dumps({"kernels": [
            kernel_line("dia_spmm", k1_launches, k1_err, (k1_cold[key1], k1_t[key1][1]),
                        k1_lib[key1], k1_bound),
            kernel_line("bell_spmm", k2_launches, k2_err, k2_t[key2], k2_lib[key2], k2_bound),
            # The four kernels of one CG iteration at q = 48, f64, DIA's state.
            kernel_line("cg_fused", FUSED_PATHS, cg_err,
                        tuple(sum(r[k] for r in cg_t.values()) for k in ("ms", "plain_ms")),
                        None, (sum(r["bound_ms"] for r in cg_t.values()),
                               "+".join(sorted({r["bound_by"] for r in cg_t.values()}))))]}))
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
