"""Low-rank GALE and GARE residuals and the `residual` dispatch (port of
the low-rank part of the JAX package's ``models/residuals.py``).

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


def residual_gare_lowrank(E, A, G: LowRank, Q: LowRank, X: LowRank,
                          r_out: int | None = None) -> LowRank:
    """GARE residual ``Q + AᵀXE + EᵀXA − EᵀXGXE`` as a compressed `LowRank`.

    Factor ``[Cᵀ  AᵀL  EᵀL]`` with middle matrix
    ``[[S,0,0],[0,0,D],[0,D,−D LᵀG L D]]``.
    """
    E = as_operator(E)
    A = as_operator(A)
    Ct, S = Q.L, Q.D
    B, Rinv = G.L, G.D
    L, D = X.L, X.D
    h = Ct.shape[1]
    r = L.shape[1]
    BtLD = (B.T @ L) @ D
    R = torch.cat([Ct, A.tmm(L), E.tmm(L)], dim=1)
    dim = h + 2 * r
    T = R.new_zeros((dim, dim))
    T[:h, :h] = S
    T[h:h + r, h + r:] = D
    T[h + r:, h:h + r] = D
    T[h + r:, h + r:] = -(BtLD.T @ Rinv @ BtLD)
    res = LowRank(L=R, D=T, k=min(Q.k + 2 * X.k, dim))
    return lr_compress(res, r_out=r_out)


def residual(prob, X, **kw):
    """The residual of ``X`` for a GALE or GARE problem, as a compressed
    `LowRank`.  Only the low-rank forms are ported: a dense ``X`` or right-
    hand side raises (ROADMAP Queue 1 item 7, the dense path)."""
    from .problems import GALEProblem, GAREProblem

    if isinstance(prob, GALEProblem):
        if isinstance(X, LowRank) and isinstance(prob.C, LowRank):
            return residual_gale_lowrank(prob.E, prob.A, prob.C, X, **kw)
        raise NotImplementedError("the dense GALE residual is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")
    if isinstance(prob, GAREProblem):
        if isinstance(X, LowRank):
            return residual_gare_lowrank(prob.E, prob.A, prob.G, prob.Q, X, **kw)
        raise NotImplementedError("the dense GARE residual is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")
    raise TypeError(f"no residual for problem type {type(prob)}")
