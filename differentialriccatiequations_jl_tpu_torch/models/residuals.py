"""GALE and GARE residuals, low-rank and dense, and the `residual`
dispatch (port of the JAX package's ``models/residuals.py``).

The low-rank residual never forms the n×n matrix: it assembles a factor
``R = [G  EᵀL  AᵀL]`` with a small block middle matrix and compresses
(Benner–Li–Penzl 2008).  The dense residuals form it.  On row-sharded
operators the low-rank residuals run under their mesh (``R`` split by rows,
the compression a TSQR).
"""

from __future__ import annotations

import torch

from ..lowrank import LowRank, lr_compress
from ..ops.operators import as_operator
from ..parallel.mesh import on_operator_mesh, row_allreduce
from .lyapunov_dense import _dense


@on_operator_mesh
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


@on_operator_mesh
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
    BtLD = row_allreduce(B.T @ L) @ D
    R = torch.cat([Ct, A.tmm(L), E.tmm(L)], dim=1)
    dim = h + 2 * r
    T = R.new_zeros((dim, dim))
    T[:h, :h] = S
    T[h:h + r, h + r:] = D
    T[h + r:, h:h + r] = D
    T[h + r:, h + r:] = -(BtLD.T @ Rinv @ BtLD)
    res = LowRank(L=R, D=T, k=min(Q.k + 2 * X.k, dim))
    return lr_compress(res, r_out=r_out)


def residual_gale_dense(E, A, C, X: torch.Tensor) -> torch.Tensor:
    """Dense GALE residual ``C + AᵀXE + EᵀXA``."""
    E = as_operator(E)
    A = as_operator(A)
    return _dense(C) + A.tmm(X) @ E.to_dense() + E.tmm(X) @ A.to_dense()


def residual_gare_dense(E, A, G: LowRank, Q, X: torch.Tensor) -> torch.Tensor:
    """Dense GARE residual ``Q + AᵀXE + EᵀXA − EᵀXGXE``."""
    E = as_operator(E)
    A = as_operator(A)
    Ed = E.to_dense()
    BtXE = (G.L.T @ X) @ Ed
    return (_dense(Q) + A.tmm(X) @ Ed + E.tmm(X) @ A.to_dense()
            - BtXE.T @ G.D @ BtXE)


def residual(prob, X, **kw):
    """The residual of ``X`` for a GALE or GARE problem: a compressed
    `LowRank` for a low-rank ``X`` (and right-hand side), else a dense
    tensor."""
    from .problems import GALEProblem, GAREProblem

    if isinstance(prob, GALEProblem):
        if isinstance(X, LowRank) and isinstance(prob.C, LowRank):
            return residual_gale_lowrank(prob.E, prob.A, prob.C, X, **kw)
        return residual_gale_dense(prob.E, prob.A, prob.C, X)
    if isinstance(prob, GAREProblem):
        if isinstance(X, LowRank):
            return residual_gare_lowrank(prob.E, prob.A, prob.G, prob.Q, X, **kw)
        return residual_gare_dense(prob.E, prob.A, prob.G, prob.Q, X)
    raise TypeError(f"no residual for problem type {type(prob)}")
