"""Matrix-valued (flexible) GMRES for GALE problems (port of the JAX
package's ``models/gmres.py``).

FGMRES (Saad 1993, Alg. 2.2) on the Lyapunov operator

    𝓛 X = AᵀXE + EᵀXA,     𝓛 · (Z, Y) = ([EᵀZ AᵀZ], [[0,Y],[Y,0]])

with low-rank Krylov "vectors", optional low-rank compression of the basis
vectors, and an optional Lyapunov-solver preconditioner (an ADI config, or
a prepared callable such as the compiled capped ADI of
`models.compiled.make_compiled_adi_preconditioner`) applied per Krylov
vector.  The Hessenberg matrix and its least-squares problem live on the
host (numpy); the inner products ``lr_dot`` and norms ``lr_norm`` are read
back at every Arnoldi step, as in the JAX package.  All matrix work is
low-rank algebra on the tensors' device; on sparse pencils the products
``EᵀZ``, ``AᵀZ`` run through K1 or K2.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..config import eps
from ..lowrank import (
    LowRank, lr_add, lr_compress, lr_dot, lr_norm, lr_scale, lr_zero, round_up)
from ..utils.callbacks import notify
from ..utils.timers import timeit
from . import shifts as shifts_mod
from .problems import ADI, GALEProblem, GMRES
from .residuals import residual_gale_lowrank


def _apply_lyapunov_operator(E, A, X: LowRank) -> LowRank:
    """``𝓛 X`` in factored form; the storage width doubles."""
    Z, Y = X.L, X.D
    r = Z.shape[1]
    L2 = torch.cat([E.tmm(Z), A.tmm(Z)], dim=1)
    Y2 = Y.new_zeros((2 * r, 2 * r))
    Y2[:r, r:] = Y
    Y2[r:, :r] = Y
    return LowRank(L=L2, D=Y2, k=min(2 * X.k, 2 * r))


def specialize(alg, prob):
    """Initialize expensive shift strategies once per problem: the
    preconditioner's ADI then draws from one shared oracle (a cyclic one
    keeps its position from one application to the next)."""
    if isinstance(alg, (shifts_mod.Cyclic, shifts_mod.Heuristic)):
        return shifts_mod.init_shifts(alg, prob)
    if isinstance(alg, ADI):
        return dataclasses.replace(alg, shifts=specialize(alg.shifts, prob))
    if isinstance(alg, GMRES):
        return dataclasses.replace(alg, preconditioner=specialize(alg.preconditioner, prob))
    return alg


def solve_gale_gmres(prob: GALEProblem, alg: GMRES, *, initial_guess=None,
                     abstol=None, observer=None) -> LowRank:
    """Restarted FGMRES on ``AᵀXE + EᵀXA = −C`` (low-rank ``C``): at most
    ``alg.maxrestarts + 1`` cycles of ``alg.maxiters`` Arnoldi steps.  Each
    cycle stops early on a happy breakdown (``h_{j+1,j} ≤ 1e4·eps·β``) or
    when its least-squares residual reaches ``abstol``; after each cycle the
    true residual of the updated ``X`` decides whether to restart."""
    from .adi import solve_gale_adi  # the preconditioner's solver

    notify(observer, "gale_start", prob, alg)
    E, A, C = prob.E, prob.A, prob.C
    n = prob.n
    dtype = C.dtype
    maxiters, maxrestarts = alg.maxiters, alg.maxrestarts

    if alg.ignore_initial_guess or initial_guess is None:
        X = lr_zero(n, C.r, dtype, device=C.device)
    else:
        X = initial_guess

    reltol = alg.reltol if alg.reltol is not None else n * eps(dtype)
    if abstol is None:
        abstol = alg.abstol if alg.abstol is not None else reltol * float(lr_norm(C))

    precond = specialize(alg.preconditioner, prob)

    H = np.zeros((maxiters + 1, maxiters))
    b = np.zeros(maxiters + 1)

    m = 0
    residual_norm = np.inf
    restarts = 0
    for restarts in range(maxrestarts + 1):
        m = 0
        R0 = residual_gale_lowrank(E, A, C, X)
        beta = residual_norm = float(lr_norm(R0))
        notify(observer, "gale_step", 0, X, R0, beta)
        if beta <= abstol:
            break

        V: list = [None] * (maxiters + 1)
        Z: list = [None] * maxiters
        V[0] = lr_scale(1.0 / beta, R0)
        H[:] = 0.0
        b[:] = 0.0
        b[0] = beta
        y = np.zeros(0)
        for j in range(maxiters):
            if precond is None:
                Z[j] = V[j]
            elif callable(precond):
                with timeit("gmres.preconditioner"):
                    Z[j] = precond(GALEProblem(E, A, V[j]))
            else:
                with timeit("gmres.preconditioner"):
                    Z[j] = solve_gale_adi(GALEProblem(E, A, V[j]), precond,
                                          observer=observer)
            with timeit("gmres.lyapunov_op"):
                W = _apply_lyapunov_operator(E, A, Z[j])
            if alg.compression:
                W = lr_compress(W, r_out=round_up(W.k + 1, 8))
            for i in range(j + 1):
                H[i, j] = float(lr_dot(V[i], W))
                W = lr_add(W, lr_scale(-H[i, j], V[i]), r_out=W.r + V[i].r)
            hjj = float(lr_norm(W))
            H[j + 1, j] = hjj

            # Least squares min ‖b − Hy‖ for the current Hessenberg block.
            m = j + 1
            Hm = H[:m + 1, :m]
            bm = b[:m + 1]
            y, *_ = np.linalg.lstsq(Hm, bm, rcond=None)
            residual_norm = float(np.linalg.norm(bm - Hm @ y))
            # Happy breakdown: the Krylov space is invariant, the solution
            # exact in it; normalizing W would divide by ~0.
            if hjj <= 1e4 * eps(dtype) * beta:
                break
            if residual_norm <= abstol:
                break
            V[j + 1] = lr_scale(1.0 / hjj, W)
            notify(observer, "gale_step", m, None, None, residual_norm)
            if alg.compression:
                V[j + 1] = lr_compress(V[j + 1], r_out=round_up(V[j + 1].k + 1, 8))

        # X ← X − Σ y_j Z_j  (the residual convention is C + 𝓛X).
        for jj in range(m):
            X = lr_add(X, lr_scale(-float(y[jj]), Z[jj]), r_out=X.r + Z[jj].r)
        if alg.compression:
            X = lr_compress(X, r_out=round_up(X.k + 1, 8))
        # The least-squares estimate drifts from the true residual under
        # basis compression: stop (and warn) only on the true residual.
        residual_norm = float(lr_norm(residual_gale_lowrank(E, A, C, X)))
        notify(observer, "gale_step", m, X, None, residual_norm)
        if residual_norm <= abstol:
            break

    if residual_norm > abstol:
        notify(observer, "gale_failed")
        if alg.warn_convergence:
            warnings.warn(
                f"GMRES did not converge: residual={residual_norm:g} "
                f"abstol={abstol:g} maxrestarts={maxrestarts} "
                f"maxiters={maxiters}")

    iters = restarts * maxiters + m
    notify(observer, "gale_done", iters, X, None, residual_norm)
    return X
