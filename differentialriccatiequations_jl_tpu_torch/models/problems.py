"""Problem and solution types (port of the part of the JAX package's
``models/problems.py`` that the compiled sweeps use).

* `GDREProblem` — ``EᵀẊE = CᵀC + AᵀXE + EᵀXA − EᵀXBBᵀXE`` on ``tspan``,
* `GAREProblem` — ``Q + AᵀXE + EᵀXA − EᵀXGXE = 0``,
* `DRESolution` — the trajectory of states ``X`` and feedbacks ``K = BᵀXE``.
"""

from __future__ import annotations

import torch

from ..lowrank import LowRank
from ..ops.operators import as_operator


class GDREProblem:
    """Generalized differential Riccati equation."""

    def __init__(self, E, A, B, C, X0, tspan):
        self.E = as_operator(E)
        self.A = as_operator(A)
        self.B = torch.as_tensor(B)
        self.C = torch.as_tensor(C)
        self.X0 = X0  # LowRank
        self.tspan = (float(tspan[0]), float(tspan[1]))

    @property
    def n(self) -> int:
        return self.B.shape[0]


class GAREProblem:
    """Generalized continuous-time algebraic Riccati equation.

    ``G`` and ``Q`` are `LowRank` factorizations (``G = B Bᵀ`` scaled,
    ``Q = Cᵀ C``)."""

    def __init__(self, E, A, G: LowRank, Q: LowRank):
        self.E = as_operator(E)
        self.A = as_operator(A)
        self.G = G
        self.Q = Q

    @property
    def n(self) -> int:
        return self.G.n


class DRESolution:
    """GDRE trajectory: states `X`, feedbacks `K = BᵀXE`, times `t`."""

    def __init__(self, X, K, t):
        self.X = X
        self.K = K
        self.t = t
