"""(Inexact) Kleinman–Newton for generalized algebraic Riccati equations,
driven from the host (port of the JAX package's ``models/newton.py``).

Each Newton step solves the closed-loop GALE with ``F = A − BK`` by the
warm-started host ADI (`models.adi`), or by FGMRES (`models.gmres`) when
the inner solver is a `GMRES` config; the inner tolerance follows the
forcing term, with an optional hybrid switch back to the classical
tolerance, and an Armijo line search guards against too little decrease of
the residual.  ``G`` and ``Q`` must carry identity inner factors
(``G = BBᵀ``, ``Q = CᵀC``).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import eps
from ..lowrank import (
    LowRank, lr_add, lr_compress, lr_norm, lr_scale, lr_slice_active, lr_zero, round_up)
from ..ops.operators import lr_update
from ..ops.shifted import ShiftedSolveCache
from ..utils.callbacks import notify
from ..utils.timers import timeit
from .adi import solve_gale_adi
from .gmres import solve_gale_gmres
from .problems import ADI, GALEProblem, GAREProblem, GMRES, Newton
from .residuals import residual_gare_lowrank


def _check_identity_inner(M: LowRank, name: str) -> None:
    r = M.k
    if not np.allclose(M.D[:r, :r].cpu().numpy(), np.eye(r)):
        raise NotImplementedError(f"{name} must have an identity inner factor")


def solve_gare_newton(prob: GAREProblem, alg: Newton, *, observer=None) -> LowRank:
    _check_identity_inner(prob.G, "G")
    _check_identity_inner(prob.Q, "Q")
    notify(observer, "gare_start", prob, alg)

    E, A, Q = prob.E, prob.A, prob.Q
    B = prob.G.L[:, :prob.G.k]
    Ct = Q.L[:, :Q.k]
    n = prob.n
    m = B.shape[1]
    q = Ct.shape[1]
    dtype = B.dtype

    res = Q
    res_norm = float(lr_norm(res))
    reltol = alg.reltol if alg.reltol is not None else n * eps(dtype)
    abstol = alg.abstol if alg.abstol is not None else reltol * res_norm

    X = lr_zero(n, max(q + m, 16), dtype, device=B.device)

    inner_alg = alg.inner_alg
    inner_reltol = (inner_alg.reltol
                    if isinstance(inner_alg, (ADI, GMRES)) and inner_alg.reltol is not None
                    else reltol / 10.0)

    # The closed-loop coefficient is A − BK with a constant A: shifted-core
    # factorizations are shared by all Newton steps.
    shift_cache = ShiftedSolveCache()

    i = 0
    X_prev = None
    while True:
        L, D = X.L, X.D
        EtL = E.tmm(L)
        BtLD = (B.T @ L) @ D
        K = BtLD @ EtL.T
        with timeit("newton.residual"):
            res = residual_gare_lowrank(E, A, prob.G, Q, X)
            res_norm_prev = res_norm
            res_norm = float(lr_norm(res))

        if i > 0 and alg.linesearch:
            armijo = 0.1
            if res_norm > (1.0 - armijo) * res_norm_prev:
                X_tilde = X
                beta = 0.5
                lam = beta
                while True:
                    X = lr_add(lr_scale(1.0 - lam, X_prev), lr_scale(lam, X_tilde),
                               r_out=X_prev.r + X_tilde.r)
                    X = lr_compress(X, r_out=round_up(X.k + 1, 16))
                    res = residual_gare_lowrank(E, A, prob.G, Q, X)
                    res_norm = float(lr_norm(res))
                    if res_norm < (1.0 - lam * armijo) * res_norm_prev:
                        L, D = X.L, X.D
                        EtL = E.tmm(L)
                        BtLD = (B.T @ L) @ D
                        K = BtLD @ EtL.T
                        break
                    lam *= beta
                    if lam < eps(dtype):
                        warnings.warn("Line search failed; using un-modified iterate")
                        X = X_tilde
                        break
                notify(observer, "gare_metadata", "line search", lam)

        notify(observer, "gare_step", i, X, res, res_norm)

        if res_norm <= abstol:
            break
        if i >= alg.maxiters:
            notify(observer, "gare_failed")
            warnings.warn(f"Newton method did not converge: residual={res_norm:g} "
                          f"abstol={abstol:g} maxiters={alg.maxiters}")
            break
        i += 1

        # Closed-loop coefficient and right-hand side.
        F = lr_update(A, -1.0, B, K)
        EtXB = EtL @ BtLD.T  # (n, m)
        G = torch.cat([Ct, EtXB], dim=1)
        RHS = LowRank(L=G, D=torch.eye(q + m, dtype=dtype, device=G.device), k=q + m)

        lyap = GALEProblem(E, F, RHS)
        if alg.inexact:
            eta = alg.inexact_forcing(i, res_norm)
            inner_abstol = eta * res_norm
            if alg.inexact_hybrid:
                # Back to the classical tolerance where it is the looser one.
                classical_abstol = inner_reltol * float(lr_norm(RHS))
                switch_back = classical_abstol > inner_abstol
                notify(observer, "gare_metadata", "inexact", not switch_back)
                if switch_back:
                    inner_abstol = classical_abstol
            else:
                notify(observer, "gare_metadata", "inexact", True)
        else:
            inner_abstol = inner_reltol * float(lr_norm(RHS))

        X_prev = X
        with timeit("newton.gale_solve"):
            if isinstance(inner_alg, GMRES):
                X = lr_slice_active(solve_gale_gmres(
                    lyap, inner_alg, abstol=inner_abstol, initial_guess=X_prev,
                    observer=observer))
            else:
                X = lr_slice_active(solve_gale_adi(
                    lyap, inner_alg, abstol=inner_abstol, initial_guess=X_prev,
                    observer=observer, shift_cache=shift_cache))

    notify(observer, "gare_done", i, X, res, res_norm)
    return X
