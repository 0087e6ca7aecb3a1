"""Shifted pencil operators ``Aᵀ + μEᵀ`` — the host ADI's hot path (port
of the JAX package's ``ops/shifted.py``).

Each ADI iteration solves ``(Aᵀ + μEᵀ)V = W``.  ``A`` is typically a lazy
closed-loop update ``A₀ − BK``, so the shifted operator is *sparse or dense
core + low-rank correction* and the solve routes through
Sherman–Morrison–Woodbury with a factorization of the core only.  A complex
shift gives a complex operator; its products still run through K1 and K2
(`kernels.complex_route`).
"""

from __future__ import annotations

import torch

from .blocklinear import Backslash, Krylov, ShermanMorrisonWoodbury, prepare
from .dia import DiaOp, shifted_dia
from .operators import DenseOp, LowRankUpdateOp, as_operator
from .sparse import BellOp


def shifted_operator(E, A, mu):
    """The operator ``Aᵀ + μEᵀ`` (lazy for a low-rank-updated ``A``).
    ``mu`` is a Python number; a complex one makes the operator complex."""
    E = as_operator(E)
    A = as_operator(A)
    if isinstance(A, LowRankUpdateOp):
        core = shifted_operator(E, A.A, mu)
        # (A₀ + α⁻¹UV)ᵀ + μEᵀ = (A₀ᵀ + μEᵀ) + α⁻¹ Vᵀ Uᵀ
        dtype = core.dtype
        alpha = A.alpha.to(dtype) if isinstance(A.alpha, torch.Tensor) else A.alpha
        return LowRankUpdateOp(core, alpha, A.V.T.to(dtype), A.U.T.to(dtype))
    if isinstance(A, DenseOp) and isinstance(E, DenseOp):
        return DenseOp(A.M.T + mu * E.M.T)
    if isinstance(A, DiaOp):
        return shifted_dia(E, A, mu)
    if isinstance(A, BellOp):
        # Only multiplied, never transposed: no transposed structure (at
        # n = 79841 that saves 572 MB of f64 blocks per shift).
        At, Et = A.adjoint(), E.adjoint()
        return BellOp(cols=At.cols, data=At.data + mu * Et.data, cols_t=None,
                      data_t=None, diag_=At.diag_ + mu * Et.diag_, n=A.n, bs=A.bs)
    raise TypeError(f"no shifted operator for {type(A).__name__}")


def default_inner_alg(A) -> object:
    """The natural solver for a shifted coefficient: dense LU, SMW around the
    core's solver for a low-rank update, Krylov for sparse operators."""
    A = as_operator(A)
    if isinstance(A, LowRankUpdateOp):
        return ShermanMorrisonWoodbury(outer=default_inner_alg(A.A), inner=Backslash())
    if isinstance(A, DenseOp):
        return Backslash()
    return Krylov()


def prepare_shifted(E, A, mu, alg=None):
    """Factor or prepare a solver for ``(Aᵀ + μEᵀ)V = W``."""
    op = shifted_operator(E, A, mu)
    if alg is None:
        alg = default_inner_alg(op)
    return prepare(op, alg)


class ShiftedSolveCache:
    """Cross-iteration cache of factored shifted cores ``A₀ᵀ + μEᵀ``.

    The core of a shifted coefficient depends only on ``(E, A₀, μ)``: it
    stays the same across ADI iterations, Newton steps (only the feedback
    ``BK`` changes) and the steps of a fixed-``dt`` Rosenbrock sweep.  The
    key is the shift as a Python ``complex`` of its host value, so the card
    and the CPU hit the same entries.  One cache per ``(E, A₀)`` pencil;
    the oldest entry goes first beyond ``max_entries``.
    """

    def __init__(self, max_entries: int = 64):
        self._core = {}
        self.max_entries = max_entries

    def core_solver(self, mu: complex, build):
        key = complex(mu)
        s = self._core.get(key)
        if s is None:
            if len(self._core) >= self.max_entries:
                self._core.pop(next(iter(self._core)))
            s = self._core[key] = build()
        return s

    def __len__(self):
        return len(self._core)


def solve_shifted(E, A, mu, W, alg=None):
    return prepare_shifted(E, A, mu, alg).solve(W)
