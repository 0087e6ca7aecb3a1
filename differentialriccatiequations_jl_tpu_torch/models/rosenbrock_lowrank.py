"""Low-rank (LRSIF) Rosenbrock integrators for GDRE problems (port of the
JAX package's ``models/rosenbrock_lowrank.py``).

A fixed-step time loop on an ``X = L D Lᵀ`` state, driven from the host.
Each step assembles a GALE whose coefficient is the lazy closed-loop update
``F = (A + c·E) − BK`` and whose right-hand side is a small concatenated
low-rank factorization, and solves it with the host ADI (`models.adi`),
warm-started with the previous state for Ros1.  `time_grid`, `feedback_K`
and the right-hand sides also serve the compiled sweeps
(`models.compiled`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..lowrank import LowRank, lr_add, lr_compress, lr_scale, lr_slice_active
from ..ops.operators import lin_comb, lr_update, scale_op
from ..ops.shifted import ShiftedSolveCache
from ..parallel.mesh import on_operator_mesh, row_allreduce
from ..utils.callbacks import notify
from ..utils.timers import timeit
from .adi import solve_gale_adi
from .problems import ADI, DRESolution, GALEProblem, GDREProblem, Ros1, Ros2


def time_grid(tspan, dt: float) -> np.ndarray:
    """``t0:dt:tf`` — fixed-step grid, negative ``dt`` integrates backward."""
    t0, tf = tspan
    nsteps = int(round((tf - t0) / dt))
    if nsteps < 1 or not math.isclose(t0 + nsteps * dt, tf, rel_tol=1e-9, abs_tol=1e-9):
        raise ValueError(f"dt={dt} does not evenly divide tspan={tspan}")
    return t0 + dt * np.arange(nsteps + 1)


@on_operator_mesh
def feedback_K(E, B: torch.Tensor, X: LowRank) -> torch.Tensor:
    """``K = Bᵀ X E`` in factored form ``(BᵀLD)(LᵀE)``.  With a row-sharded
    ``E`` (``B`` and ``L`` split by rows) ``BᵀL`` is all-reduced and ``K``
    comes out split by columns: each rank's columns."""
    BtLD = row_allreduce(B.T @ X.L) @ X.D
    return BtLD @ E.tmm(X.L).T


def _ros1_rhs(E, B, C, X: LowRank, tau: float) -> LowRank:
    """Ros1 right-hand side ``[Cᵀ EᵀL] · blkdiag(I_q, (BᵀLD)ᵀ(BᵀLD) + D/τ)``,
    compressed."""
    q = C.shape[0]
    L, D = X.L, X.D
    r = L.shape[1]
    BtLD = (B.T @ L) @ D
    G = torch.cat([C.T, E.tmm(L)], dim=1)
    S = G.new_zeros((q + r, q + r))
    S[:q, :q] = torch.eye(q, dtype=G.dtype, device=G.device)
    S[q:, q:] = BtLD.T @ BtLD + D / tau
    return lr_compress(LowRank(L=G, D=S, k=min(q + X.k, q + r)))


def solve_gdre_lowrank_ros1(prob: GDREProblem, alg: Ros1, *, dt: float,
                            save_state: bool = False, observer=None) -> DRESolution:
    """LRSIF Ros1 (implicit Euler) on a fixed grid with step ``dt``."""
    notify(observer, "gdre_start", prob, alg)
    E, A, B, C = prob.E, prob.A, prob.B, prob.C
    X = prob.X0
    tstops = time_grid(prob.tspan, dt)

    Xs = [X]
    K = feedback_K(E, B, X)
    Ks = [K]
    notify(observer, "gdre_step", float(tstops[0]), X, K)

    inner_alg = alg.inner_alg if alg.inner_alg is not None else ADI()
    # The shifted core (A − E/(2τ))ᵀ + μEᵀ is the same at every step (τ is
    # constant): one cache serves the whole trajectory.
    tau0 = float(tstops[0] - tstops[1])
    F_base = lin_comb(A, -1.0 / (2.0 * tau0), E)
    cache = ShiftedSolveCache()
    for i in range(1, len(tstops)):
        tau = float(tstops[i - 1] - tstops[i])
        F = lr_update(F_base, -1.0, B, K)  # F = (A − E/(2τ)) − BK
        R = _ros1_rhs(E, B, C, X, tau)
        with timeit("gdre.gale_solve"):
            X = solve_gale_adi(GALEProblem(E, F, R), inner_alg, initial_guess=X,
                               observer=observer, shift_cache=cache)
        X = lr_slice_active(X)
        if save_state:
            Xs.append(X)
        K = feedback_K(E, B, X)
        Ks.append(K)
        notify(observer, "gdre_step", float(tstops[i]), X, K)

    if not save_state:
        Xs.append(X)
    notify(observer, "gdre_done")
    return DRESolution(Xs, Ks, tstops)


def _ros2_rhs1(E, A, B, C, X: LowRank) -> LowRank:
    """Ros2 stage-1 right-hand side ``[Cᵀ AᵀL EᵀL]`` with the indefinite
    3×3 block inner factor, compressed (``BᵀL`` all-reduced over the active
    mesh)."""
    q = C.shape[0]
    L, D = X.L, X.D
    r = L.shape[1]
    BtLD = row_allreduce(B.T @ L) @ D
    G = torch.cat([C.T, A.tmm(L), E.tmm(L)], dim=1)
    dim = q + 2 * r
    S = G.new_zeros((dim, dim))
    S[:q, :q] = torch.eye(q, dtype=G.dtype, device=G.device)
    S[q:q + r, q + r:] = D
    S[q + r:, q:q + r] = D
    S[q + r:, q + r:] = -(BtLD.T @ BtLD)
    return lr_compress(LowRank(L=G, D=S, k=min(q + 2 * X.k, dim)))


def _ros2_rhs2(E, B, K1: LowRank, tau: float, gamma: float) -> LowRank:
    """Ros2 stage-2 right-hand side built from the stage-1 solution
    (``BᵀT₁`` all-reduced over the active mesh)."""
    T1, D1 = K1.L, K1.D
    BtT1D1 = row_allreduce(B.T @ T1) @ D1
    G2 = E.tmm(T1)
    S2 = (tau ** 2) * (BtT1D1.T @ BtT1D1) + (2.0 - 1.0 / gamma) * D1
    return LowRank(L=G2, D=S2, k=K1.k)


def solve_gdre_lowrank_ros2(prob: GDREProblem, alg: Ros2, *, dt: float,
                            save_state: bool = False, observer=None) -> DRESolution:
    """LRSIF Ros2 (two-stage Rosenbrock) on a fixed grid with step ``dt``."""
    notify(observer, "gdre_start", prob, alg)
    E, A, B, C = prob.E, prob.A, prob.B, prob.C
    X = prob.X0
    tstops = time_grid(prob.tspan, dt)
    gamma = 1.0 + 1.0 / math.sqrt(2.0)

    Xs = [X]
    K = feedback_K(E, B, X)
    Ks = [K]
    notify(observer, "gdre_step", float(tstops[0]), X, K)

    inner_alg = alg.inner_alg if alg.inner_alg is not None else ADI()
    # γτ·A − E/2 is the same at every step: one cache for all steps and
    # both stages.
    tau0 = float(tstops[0] - tstops[1])
    F_base = lin_comb(scale_op(A, gamma * tau0), -0.5, E)
    cache = ShiftedSolveCache()
    for i in range(1, len(tstops)):
        tau = float(tstops[i - 1] - tstops[i])
        gt = gamma * tau
        F = lr_update(F_base, -1.0 / gt, B, K)  # F = γτ·A − E/2 − γτ·BK

        R1 = _ros2_rhs1(E, A, B, C, X)
        K1 = solve_gale_adi(GALEProblem(E, F, R1), inner_alg, observer=observer,
                            shift_cache=cache)
        R2 = _ros2_rhs2(E, B, K1, tau, gamma)
        K2 = solve_gale_adi(GALEProblem(E, F, R2), inner_alg, observer=observer,
                            shift_cache=cache)

        # X ← X + (2 − 1/(2γ))τ·K1 − (τ/2)·K2
        K1 = lr_slice_active(K1)
        K2 = lr_slice_active(K2)
        X = lr_add(X, lr_scale((2.0 - 1.0 / (2.0 * gamma)) * tau, K1), r_out=X.r + K1.r)
        X = lr_add(X, lr_scale(-tau / 2.0, K2), r_out=X.r + K2.r)
        X = lr_slice_active(lr_compress(X))
        if save_state:
            Xs.append(X)

        K = feedback_K(E, B, X)
        Ks.append(K)
        notify(observer, "gdre_step", float(tstops[i]), X, K)

    if not save_state:
        Xs.append(X)
    notify(observer, "gdre_done")
    return DRESolution(Xs, Ks, tstops)
