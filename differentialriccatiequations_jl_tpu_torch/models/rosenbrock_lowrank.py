"""Pieces of the low-rank (LRSIF) Rosenbrock integrators that the compiled
sweeps use (port of the JAX package's ``models/rosenbrock_lowrank.py``,
``time_grid``, ``feedback_K`` and the Ros2 right-hand sides)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..lowrank import LowRank, lr_compress


def time_grid(tspan, dt: float) -> np.ndarray:
    """``t0:dt:tf`` — fixed-step grid, negative ``dt`` integrates backward."""
    t0, tf = tspan
    nsteps = int(round((tf - t0) / dt))
    if nsteps < 1 or not math.isclose(t0 + nsteps * dt, tf, rel_tol=1e-9, abs_tol=1e-9):
        raise ValueError(f"dt={dt} does not evenly divide tspan={tspan}")
    return t0 + dt * np.arange(nsteps + 1)


def feedback_K(E, B: torch.Tensor, X: LowRank) -> torch.Tensor:
    """``K = Bᵀ X E`` in factored form ``(BᵀLD)(LᵀE)``."""
    BtLD = (B.T @ X.L) @ X.D
    return BtLD @ E.tmm(X.L).T


def _ros2_rhs1(E, A, B, C, X: LowRank) -> LowRank:
    """Ros2 stage-1 right-hand side ``[Cᵀ AᵀL EᵀL]`` with the indefinite
    3×3 block inner factor, compressed."""
    q = C.shape[0]
    L, D = X.L, X.D
    r = L.shape[1]
    BtLD = (B.T @ L) @ D
    G = torch.cat([C.T, A.tmm(L), E.tmm(L)], dim=1)
    dim = q + 2 * r
    S = G.new_zeros((dim, dim))
    S[:q, :q] = torch.eye(q, dtype=G.dtype, device=G.device)
    S[q:q + r, q + r:] = D
    S[q + r:, q:q + r] = D
    S[q + r:, q + r:] = -(BtLD.T @ BtLD)
    return lr_compress(LowRank(L=G, D=S, k=min(q + 2 * X.k, dim)))


def _ros2_rhs2(E, B, K1: LowRank, tau: float, gamma: float) -> LowRank:
    """Ros2 stage-2 right-hand side built from the stage-1 solution."""
    T1, D1 = K1.L, K1.D
    BtT1D1 = (B.T @ T1) @ D1
    G2 = E.tmm(T1)
    S2 = (tau ** 2) * (BtT1D1.T @ BtT1D1) + (2.0 - 1.0 / gamma) * D1
    return LowRank(L=G2, D=S2, k=K1.k)
