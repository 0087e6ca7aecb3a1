"""Low-rank GALE residual (port of the JAX package's ``models/residuals.py``,
the part the compiled Ros1 step uses).

The residual never forms the n×n matrix: it assembles a factor
``R = [G  EᵀL  AᵀL]`` with a small block middle matrix and compresses
(Benner–Li–Penzl 2008).
"""

from __future__ import annotations

import torch

from ..lowrank import LowRank, lr_compress
from ..ops.operators import as_operator


def residual_gale_lowrank(E, A, C: LowRank, X: LowRank,
                          r_out: int | None = None) -> LowRank:
    """GALE residual ``C + AᵀXE + EᵀXA`` as a compressed `LowRank`.

    Factor ``[G  EᵀL  AᵀL]`` with middle matrix
    ``[[S,0,0],[0,0,D],[0,D,0]]``.
    """
    E = as_operator(E)
    A = as_operator(A)
    G, S = C.L, C.D
    L, D = X.L, X.D
    qg = G.shape[1]
    r = L.shape[1]
    R = torch.cat([G, E.tmm(L), A.tmm(L)], dim=1)
    dim = qg + 2 * r
    T = R.new_zeros((dim, dim))
    T[:qg, :qg] = S
    T[qg:qg + r, qg + r:] = D
    T[qg + r:, qg:qg + r] = D
    res = LowRank(L=R, D=T, k=min(C.k + 2 * X.k, dim))
    return lr_compress(res, r_out=r_out)
