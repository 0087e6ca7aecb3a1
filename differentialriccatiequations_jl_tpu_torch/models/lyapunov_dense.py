"""Dense GALE solvers: the matrix-sign-function iteration (on the tensors'
device), the SciPy oracle and the Kronecker solve (port of the JAX
package's ``models/lyapunov_dense.py``).

Solving ``AᵀXE + EᵀXA = −C`` reduces, with ``M = A E⁻¹`` and
``C̃ = E⁻ᵀ C E⁻¹``, to ``MᵀX + XM = −C̃``.  The determinant-scaled Newton
iteration for the sign function

    M_{k+1} = (M_k/c_k + c_k M_k⁻¹)/2,
    C_{k+1} = (C_k/c_k + c_k M_k⁻ᵀ C_k M_k⁻¹)/2,      c_k = |det M_k|^{1/n}

gives ``X = lim C_k / 2``.  Each M-step is one LU and one inversion
(cuSOLVER on the card), each C-step two GEMMs (cuBLAS, f64).  torch has no
generalized Schur (QZ) decomposition, so the reference's Bartels–Stewart
becomes this iteration, as in the JAX package.

`SignFunctionCache` runs the M-iteration once and stores the inverse
sequence, so each further right-hand side (a Rosenbrock stage) replays only
the C-updates.  The iteration runs a fixed ``maxiters`` with no early exit
(after convergence ``M ≈ −I`` and the tail is a run of fixed points), and
reads nothing back to the host.  A cache build and a stage solve are each a
`timeit` span (``lyapunov_dense.sign_cache``, ``lyapunov_dense.solve``), and
the host counts the M-steps and C-updates run (`sign_iterations`,
`replay_iterations`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg
import torch

from ..utils.timers import timeit

#: Sign-iteration M-steps run in this process (one LU and one inversion each).
sign_iterations = 0
#: C-updates replayed in this process (two GEMMs each), over all stage solves.
replay_iterations = 0


def _dense(X) -> torch.Tensor:
    """``X`` as a dense tensor: an operator's or `LowRank`'s matrix, or
    ``X`` itself."""
    return X.to_dense() if hasattr(X, "to_dense") else torch.as_tensor(X)


def _sign_iteration(M: torch.Tensor, maxiters: int):
    """Determinant-scaled sign iteration from ``M``.  Returns ``(M_final,
    Minvs, cs)``: the last iterate, the ``(maxiters, n, n)`` inverses and
    the ``(maxiters,)`` scales.

    ``log|det M_k|`` is read off the diagonal of the LU that also gives the
    inverse: the JAX package's ``slogdet`` computes the same sum from its own
    LU of ``M_k``, so this is the same scale with one factorization fewer."""
    n = M.shape[0]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    Minvs = M.new_empty((maxiters, n, n))
    cs = M.new_empty((maxiters,))
    for k in range(maxiters):
        lu, piv, _ = torch.linalg.lu_factor_ex(M)  # no host read of `info`
        c = torch.exp(torch.log(torch.diagonal(lu).abs()).sum() / n)
        cs[k] = torch.where(torch.isfinite(c) & (c > 0), c, torch.ones_like(c))
        torch.linalg.lu_solve(lu, piv, eye, out=Minvs[k])
        M = 0.5 * (M / cs[k] + cs[k] * Minvs[k])
    return M, Minvs, cs


def _replay_rhs(Ctil: torch.Tensor, Minvs: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """Replay the C-update sequence for one right-hand side; returns
    ``C_∞ / 2``.  (``[[M, 0], [C̃, −Mᵀ]]`` has sign ``[[−I, 0], [−2X̂, I]]``
    with ``MᵀX̂ + X̂M = C̃``; the GALE is ``MᵀX + XM = −C̃``, so
    ``X = +C_∞/2``.)"""
    C = Ctil
    for Minv, c in zip(Minvs, cs):
        C = 0.5 * (C / c + c * (Minv.T @ C @ Minv))
    return 0.5 * C


@dataclasses.dataclass(frozen=True)
class SignFunctionCache:
    """The factored pencil, reusable across the stage solves of one step
    (the reference's per-step Schur reuse, ``dense_ros2.jl:38``).  ``E_lu``
    and ``E_piv`` are `torch.linalg.lu_factor`'s (1-based LAPACK pivots)."""

    E_lu: torch.Tensor
    E_piv: torch.Tensor
    Minvs: torch.Tensor  # (maxiters, n, n)
    cs: torch.Tensor  # (maxiters,)

    def solve(self, C) -> torch.Tensor:
        """Solve ``AᵀXE + EᵀXA = −C`` for symmetric dense ``C``."""
        global replay_iterations
        with timeit("lyapunov_dense.solve"):
            C = _dense(C)
            # C̃ = E⁻ᵀ C E⁻¹ by two sweeps of solves with Eᵀ.
            EinvT_C = torch.linalg.lu_solve(self.E_lu, self.E_piv, C, adjoint=True)
            Ctil = torch.linalg.lu_solve(self.E_lu, self.E_piv, EinvT_C.T, adjoint=True).T
            X = _replay_rhs(Ctil, self.Minvs, self.cs)
            replay_iterations += self.Minvs.shape[0]
            return 0.5 * (X + X.T)


def sign_function_cache(E, A, maxiters: int = 40) -> SignFunctionCache:
    """Factor ``E`` and run the sign iteration on ``M = A E⁻¹``."""
    global sign_iterations
    with timeit("lyapunov_dense.sign_cache"):
        E, A = _dense(E), _dense(A)
        E_lu, E_piv = torch.linalg.lu_factor(E)
        # M = A E⁻¹  ⇔  Mᵀ = E⁻ᵀ Aᵀ
        M = torch.linalg.lu_solve(E_lu, E_piv, A.T, adjoint=True).T
        _, Minvs, cs = _sign_iteration(M, maxiters)
        sign_iterations += maxiters
        return SignFunctionCache(E_lu=E_lu, E_piv=E_piv, Minvs=Minvs, cs=cs)


def solve_gale_dense(E, A, C, maxiters: int = 40) -> torch.Tensor:
    """One dense GALE solve on the tensors' device (`BartelsStewart()`)."""
    return sign_function_cache(E, A, maxiters).solve(C)


def solve_gale_host(E, A, C) -> torch.Tensor:
    """GALE solve on the host CPU through SciPy's Bartels–Stewart: the
    oracle a caller asks for with `BartelsStewart(host=True)`.  Returns on
    the device of ``E``."""
    E = _dense(E)
    En, An, Cn = (_dense(M).cpu().numpy() for M in (E, A, C))
    M = np.linalg.solve(En.T, An.T).T  # A E⁻¹
    Ctil = np.linalg.solve(En.T, np.linalg.solve(En.T, Cn).T).T
    # Mᵀ X + X M = −C̃  ⇔  a Y + Y aᴴ = q with a = Mᵀ, q = −C̃
    X = scipy.linalg.solve_continuous_lyapunov(M.T, -Ctil)
    return torch.as_tensor(0.5 * (X + X.T), device=E.device)


def solve_gale_kronecker(Ed: torch.Tensor, Ad: torch.Tensor, Cd: torch.Tensor) -> torch.Tensor:
    """Direct n²×n² Kronecker solve of ``AᵀXE + EᵀXA = −C``, for tests."""
    n = Ed.shape[0]
    # vec_c(AᵀXE) = (Eᵀ ⊗ Aᵀ) vec_c(X): column-major vec through transposed
    # reshapes.
    K = torch.kron(Ed.T, Ad.T) + torch.kron(Ad.T, Ed.T)
    b = -Cd.T.reshape(-1)
    X = torch.linalg.solve(K, b).reshape(n, n).T
    return 0.5 * (X + X.T)
