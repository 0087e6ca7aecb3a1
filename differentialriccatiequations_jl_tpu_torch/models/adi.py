"""Low-rank ADI for generalized algebraic Lyapunov equations, driven from
the host (port of the JAX package's ``models/adi.py``).

One shifted solve ``(Aᵀ + μEᵀ)V = W`` per iteration, the residual factor
``W`` updated in place, complex double steps recombined into real factors.
The iteration is host-orchestrated: the shift oracle, observers and the
convergence test run in Python between steps (one host read of the
residual norm per step).  The residual factor keeps the width of the
initial residual's rank; the iterate ``X`` lives in a padded `LowRank`
buffer that grows on the host when needed.  Shifted solves route through
dense LU, Sherman–Morrison–Woodbury or Krylov by operator kind
(`ops.shifted`); on sparse operators every product is a K1 or K2 launch,
complex shifts included (`kernels.complex_route`).
"""

from __future__ import annotations

import math
import warnings

import torch

from ..config import eps
from ..lowrank import (
    LowRank, lowrank, lr_add, lr_compress, lr_norm, lr_slice_active,
    lr_with_capacity, lr_zero, round_up)
from ..ops.blocklinear import Backslash, SMWSolver, prepare
from ..ops.operators import DenseOp, LowRankUpdateOp
from ..ops.shifted import prepare_shifted
from ..parallel.mesh import row_allreduce
from ..utils.callbacks import notify
from ..utils.timers import timeit
from .problems import ADI, GALEProblem
from .residuals import residual_gale_lowrank
from .shifts import init_shifts


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as the JAX package's ``jnp.asarray(x,
    dtype)`` or ``dtype.type(x)`` (a no-op in f64)."""
    return float(torch.tensor(x, dtype=dtype))


def _step_real(E, solver, mu: float, W, T, X: LowRank):
    """One real ADI step: ``V = (Aᵀ + μEᵀ)⁻¹W``, ``X += −2μ·V T Vᵀ``,
    ``W ← W − 2μ·EᵀV``.  Returns (V, W, X)."""
    V = solver.solve(W)
    incr = LowRank(L=V, D=(-2.0 * mu) * T, k=W.shape[1])
    W_new = W - 2.0 * mu * E.tmm(V)
    return V, W_new, lr_add(X, incr, r_out=X.r)


def _step_double(E, solver, mu: complex, W, T, X: LowRank):
    """Complex double step for a conjugate shift pair: one complex solve,
    recombined into the real factors V₁, V₂.  Returns (V₁, V₂, W, X)."""
    V = solver.solve(W.to(torch.promote_types(W.dtype, torch.complex64)))
    mur = mu.real
    delta = mur / mu.imag
    Vr, Vi = V.real, V.imag
    sqrt2 = math.sqrt(2.0)
    V1 = sqrt2 * Vr + (sqrt2 * delta) * Vi
    V2 = math.sqrt(2.0 * delta**2 + 2.0) * Vi
    q = W.shape[1]
    D2 = W.new_zeros((2 * q, 2 * q))
    D2[:q, :q] = (-2.0 * mur) * T
    D2[q:, q:] = (-2.0 * mur) * T
    incr = LowRank(L=torch.cat([V1, V2], dim=1), D=D2, k=2 * q)
    W_new = W - (2.0 * sqrt2 * mur) * E.tmm(V1)
    return V1, V2, W_new, lr_add(X, incr, r_out=X.r)


def _residual_norm(W: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """‖W T Wᵀ‖_F through the Gram form ``tr((T·WᵀW)²)`` (no tall QR); ``WᵀW``
    all-reduced over the active mesh's ranks."""
    TM = T @ row_allreduce(W.T @ W)
    return torch.sqrt(torch.clamp(torch.trace(TM @ TM), min=0.0))


class ADISolver:
    """Resumable ADI solver object: `init` / `step` / `done` / `solve`."""

    def __init__(self, prob: GALEProblem, alg: ADI, *, initial_guess=None,
                 initial_residual=None, abstol=None, observer=None,
                 shift_cache=None):
        self.prob = prob
        self.alg = alg
        self.observer = observer
        self.shift_cache = shift_cache
        self._solver_cache: dict = {}  # this solve's shift -> prepared solver
        notify(observer, "gale_start", prob, alg)

        E, A, C = prob.E, prob.A, prob.C
        n = prob.n
        dtype = C.dtype

        if alg.ignore_initial_guess:
            initial_guess = None

        # Active-rank slices: the wide assemblies below scale with the
        # numerical rank, not the storage capacity.
        C_s = lr_slice_active(C)
        if initial_guess is not None:
            initial_guess = lr_slice_active(lr_compress(initial_guess))

        # For a zero or absent guess the residual is the right-hand side.
        if initial_residual is None:
            if initial_guess is None:
                initial_residual = C_s
            else:
                initial_residual = residual_gale_lowrank(E, A, C_s, initial_guess)
        res = initial_residual

        # The residual factor's width, from the numerical rank.
        k_res = max(res.k, 1)
        self.q = q = round_up(k_res, 4)
        self.W = res.L[:, :q]
        self.T = res.D[:q, :q]

        # The iterate's buffer; `_ensure_capacity` grows it on demand.
        k0 = initial_guess.r if initial_guess is not None else 0
        cap = alg.capacity or round_up(k0 + (alg.compression_interval + 2) * q, 32)
        if initial_guess is None:
            self.X = lr_zero(n, cap, dtype, device=C.device)
        else:
            self.X = lr_with_capacity(initial_guess, max(cap, k0))

        self.residual_norm = float(_residual_norm(self.W, self.T))

        self.oracle = init_shifts(alg.shifts, prob)
        self.oracle.update(self.X, self.W)
        self.shifts: list = []

        reltol = alg.reltol if alg.reltol is not None else n * eps(dtype)
        if abstol is not None:
            self.abstol = float(abstol)
        elif alg.abstol is not None:
            self.abstol = float(alg.abstol)
        else:
            self.abstol = reltol * float(lr_norm(C_s))

        self.inner_alg = alg.inner_alg
        self.last_compression = 0
        self._collapsed = False
        notify(observer, "gale_step", 0, self.X, res, self.residual_norm)

    def _ensure_capacity(self, incoming: int) -> None:
        need = self.X.k + incoming
        if need > self.X.r:
            new_cap = round_up(need + 2 * self.q * (self.alg.compression_interval + 1), 32)
            self.X = lr_with_capacity(self.X, new_cap)

    @property
    def iters(self) -> int:
        return len(self.shifts)

    def _solver_for(self, mu: complex):
        """Prepared solver for ``Aᵀ + μEᵀ``, from two cache levels: this
        solve's (shifts repeat within a cyclic sweep) and the cross-solve
        `ShiftedSolveCache` of factored dense cores."""
        key = complex(mu)
        s = self._solver_cache.get(key)
        if s is not None:
            return s
        E, A = self.prob.E, self.prob.A
        dtype = self.W.dtype
        mu_val = _in_dtype(mu.real, dtype) if mu.imag == 0.0 else mu
        cache = self.shift_cache
        if self.inner_alg is not None or cache is None:
            s = prepare_shifted(E, A, mu_val, self.inner_alg)
        elif (isinstance(A, LowRankUpdateOp) and isinstance(A.A, DenseOp)
              and isinstance(E, DenseOp)):
            # Cached core LU + a fresh SMW correction for the feedback term.
            core = cache.core_solver(
                key, lambda: prepare(DenseOp(A.A.M.T + mu_val * E.M.T), Backslash()))
            cdt = core.lu.dtype
            U = A.V.T.to(cdt)  # (n, m) of the transposed update
            Vt = A.U.T.to(cdt)  # (m, n)
            AinvU = core.solve(U)
            m = U.shape[1]
            S = A.alpha * torch.eye(m, dtype=cdt, device=U.device) + Vt @ AinvU
            s = SMWSolver(base=core, AinvU=AinvU, V=Vt,
                          schur=prepare(DenseOp(S), Backslash()))
        elif isinstance(A, DenseOp) and isinstance(E, DenseOp):
            s = cache.core_solver(key, lambda: prepare_shifted(E, A, mu_val, None))
        else:
            s = prepare_shifted(E, A, mu_val, None)
        self._solver_cache[key] = s
        return s

    def step(self) -> None:
        alg, E = self.alg, self.prob.E
        with timeit("adi.shifts"):
            mu = self.oracle.take()
        notify(self.observer, "gale_metadata", "ADI shifts", mu)
        if mu.imag == 0.0:
            self.shifts.append(mu)
            self._ensure_capacity(self.q)
            with timeit("adi.prepare_shifted"):
                solver = self._solver_for(mu)
            m = _in_dtype(mu.real, self.W.dtype)
            with timeit("adi.shifted_solve"):
                V, self.W, self.X = _step_real(E, solver, m, self.W, self.T, self.X)
            self.last_compression += 1
            with timeit("adi.shifts"):
                self.oracle.update(self.X, self.W, V)
            collapse = not bool(torch.any(V != 0))
        else:
            with timeit("adi.shifts"):
                mu2 = self.oracle.take()
            notify(self.observer, "gale_metadata", "ADI shifts", mu2)
            if abs(mu2 - mu.conjugate()) > 1e-8 * abs(mu):
                raise ValueError("complex shifts must come in conjugate pairs: "
                                 f"{mu} followed by {mu2}")
            self.shifts.extend((mu, mu2))
            self._ensure_capacity(2 * self.q)
            with timeit("adi.prepare_shifted"):
                solver = self._solver_for(mu)
            with timeit("adi.shifted_solve"):
                V1, V2, self.W, self.X = _step_double(E, solver, mu, self.W,
                                                      self.T, self.X)
            self.last_compression += 2
            with timeit("adi.shifts"):
                self.oracle.update(self.X, self.W, V1, V2)
            collapse = not (bool(torch.any(V1 != 0)) or bool(torch.any(V2 != 0)))

        self._collapsed = collapse  # the iteration collapsed

        if alg.compression and self.last_compression >= alg.compression_interval:
            self.compress()

        with timeit("adi.residual_norm"):
            self.residual_norm = float(_residual_norm(self.W, self.T))
        notify(self.observer, "gale_step", self.iters, self.X,
               self.residual_lowrank(), self.residual_norm)

        if self.residual_norm <= self.abstol:
            return
        if self.iters >= alg.maxiters:
            notify(self.observer, "gale_failed")
            if alg.warn_convergence:
                warnings.warn(
                    f"ADI did not converge: residual={self.residual_norm:g} "
                    f"abstol={self.abstol:g} maxiters={alg.maxiters}")

    def compress(self) -> None:
        with timeit("adi.compress"):
            self.X = lr_compress(self.X)
        self.last_compression = 0

    def residual_lowrank(self) -> LowRank:
        return lowrank(self.W, self.T)

    @property
    def done(self) -> bool:
        if self.residual_norm <= self.abstol:
            return True
        if self.iters > 0 and self._collapsed:
            return True
        return self.iters >= self.alg.maxiters

    def solve(self) -> LowRank:
        while not self.done:
            self.step()
        if self.alg.compression and self.last_compression > 0:
            self.compress()
        notify(self.observer, "gale_done", self.iters, self.X,
               self.residual_lowrank(), self.residual_norm)
        return self.X


def solve_gale_adi(prob: GALEProblem, alg: ADI, **kw) -> LowRank:
    return ADISolver(prob, alg, **kw).solve()
